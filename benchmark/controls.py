"""The check's control and its planted faults: what has to come out not correct.

Each is a callable ``(loop, stack)`` for ``harness.execute``'s
``controls``: it puts something else in the timed path's place, with
``stack`` undoing what it patched once the window has closed.  The
benchmark's own runs use none of them; ``control.py`` runs them on the
card and ``tests/test_bench_control.py`` on the CPU.

- ``lower_precision``, the control: the configuration states a lossless
  round trip of its dtype; the control round-trips the tensor cast to the
  next precision below (``control_dtype``: bfloat16 for float32, float32
  for float64), what a lossy offload would hand back.
- ``unchanged``: the decode's last step returns its state as it found it
  (the unfilter kernel copies its input; the host decode leaves its
  buffer as allocated, zeros).
- ``half``: the encode filters half of the full blocks and leaves the rest
  as they are; a single-block tensor has half of its bytes left out.
- ``altered_frame``, ``altered_tensor``: one byte of the answer changed
  where it is produced (the frame's assembly; the decoded tensor).
"""

from __future__ import annotations

from unittest import mock

import torch


def lower_precision(loop, stack) -> None:
    low = getattr(torch, loop.cell.config["control_dtype"])
    compress = loop.compress

    def lossy(x, opts, strategy):
        return compress(x.to(low).to(x.dtype), opts, strategy=strategy)

    loop.compress = lossy


def _flip(t: torch.Tensor) -> torch.Tensor:
    b = t.view(-1).view(torch.uint8)
    b[b.numel() // 2] ^= 1
    return t


def unchanged(loop, stack) -> None:
    from tpu_blosc_torch import device, filters

    def copy(blocks, type_size, mode, keep_raw=None, out=None):
        return out.copy_(blocks) if out is not None else blocks.clone()

    stack.enter_context(mock.patch.object(filters, "unfilter_blocks", copy))
    stack.enter_context(mock.patch.object(
        device, "host_decode", lambda data, n: torch.zeros(n, dtype=torch.uint8)))


def half(loop, stack) -> None:
    from tpu_blosc_torch import device, filters

    filter_blocks, compress_with_options = filters.filter_blocks, device.compress_with_options

    def half_filter(blocks, type_size, mode, out=None):
        h = blocks.shape[0] // 2
        out = out if out is not None else torch.empty_like(blocks)
        filter_blocks(blocks[:h], type_size, mode, out=out[:h])
        out[h:] = blocks[h:]
        return out

    def half_bytes(data, opts):
        return compress_with_options(data[: len(data) // 2], opts)

    stack.enter_context(mock.patch.object(filters, "filter_blocks", half_filter))
    stack.enter_context(mock.patch.object(device, "compress_with_options", half_bytes))


def altered_frame(loop, stack) -> None:
    from tpu_blosc_torch import device

    stage2 = device._compress_array_stage2

    def altered(staged):
        frame = bytearray(stage2(staged))
        frame[len(frame) // 2] ^= 1
        return bytes(frame)

    stack.enter_context(mock.patch.object(device, "_compress_array_stage2", altered))


def altered_tensor(loop, stack) -> None:
    from tpu_blosc_torch import device

    devfilter, host_decode = device._decompress_array_devfilter, device.host_decode

    def altered_devfilter(data, n, target):
        out = devfilter(data, n, target)
        return None if out is None else _flip(out)

    stack.enter_context(mock.patch.object(device, "_decompress_array_devfilter",
                                          altered_devfilter))
    stack.enter_context(mock.patch.object(
        device, "host_decode", lambda data, n: _flip(host_decode(data, n))))


CONTROL = lower_precision
FAULTS = {"unchanged": unchanged, "half": half, "altered_frame": altered_frame,
          "altered_tensor": altered_tensor}
