"""Command-line interface: ``python -m tpu_blosc_torch <command>``.

Counterpart: ``tpu_blosc/__main__.py:1-308``: the same seven subcommands,
flags, messages and exit codes, and the same files byte for byte.  Frames
are the bytes the library APIs write (single, chunked, or 64-bit container,
chosen by size), so each package reads the other's files.  ``suggest``,
``--auto`` and the bit-shuffle hint run ``suggest_options``; ``pack`` and
``unpack`` go through ``array.py``.

    python -m tpu_blosc_torch compress   data.bin -o data.bl2 --codec zstd
    python -m tpu_blosc_torch decompress data.bl2 -o data.out
    python -m tpu_blosc_torch info       data.bl2
    python -m tpu_blosc_torch suggest    data.bin --typesize 4
"""

from __future__ import annotations

import argparse
import sys
import time

from .errors import BloscError
from .api import (
    compress_batch_with_options,
    compress_with_options,
    decompress,
    decompress_batch,
    get_decompressed_size,
    get_info,
    suggest_options,
)
from .format import Codec, Shuffle
from .options import Options

_CODECS = {c.name.lower(): c for c in Codec}
_SHUFFLES = {
    "none": Shuffle.NOSHUFFLE,
    "byte": Shuffle.SHUFFLE,
    "bit": Shuffle.BITSHUFFLE,
}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_blosc_torch",
        description="Blosc codec CLI of the PyTorch port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress file(s) into Blosc frames")
    c.add_argument("input", nargs="+",
                   help="input file(s); several batch across all cores")
    c.add_argument("-o", "--output",
                   help="default: <input>.bl2 (single input only)")
    c.add_argument("--codec", choices=sorted(_CODECS), default="lz4")
    c.add_argument("--level", type=int, default=5)
    c.add_argument("--shuffle", choices=sorted(_SHUFFLES), default="byte")
    c.add_argument("--typesize", type=int, default=4)
    c.add_argument("--block", type=int, default=0,
                   help="block size in bytes (0 = automatic)")
    c.add_argument("--auto", action="store_true",
                   help="probe the data and pick filter+codec automatically")

    d = sub.add_parser("decompress", help="decompress Blosc frame file(s)")
    d.add_argument("input", nargs="+",
                   help="input file(s); several batch across all cores")
    d.add_argument("-o", "--output",
                   help="default: <input>.out (single input only)")

    i = sub.add_parser("info", help="print frame header/metadata")
    i.add_argument("input")

    s = sub.add_parser("suggest", help="recommend options for a file")
    s.add_argument("input")
    s.add_argument("--typesize", type=int, default=4)

    pk = sub.add_parser(
        "pack", help="compress a .npy file into a TPBA array envelope"
    )
    pk.add_argument("input")
    pk.add_argument("-o", "--output", help="default: <input>.tpba")
    pk.add_argument("--codec", choices=sorted(_CODECS), default="lz4")
    pk.add_argument("--level", type=int, default=5)
    pk.add_argument("--shuffle", choices=sorted(_SHUFFLES), default="byte")

    up = sub.add_parser(
        "unpack", help="decompress a TPBA envelope back into a .npy file"
    )
    up.add_argument("input")
    up.add_argument("-o", "--output", help="default: <input>.npy")

    v = sub.add_parser(
        "verify",
        help="integrity-check a TPBS stream/checkpoint file (crc + decode)",
    )
    v.add_argument("input")
    v.add_argument("--deep", action="store_true",
                   help="also decompress every record")
    return p


def _warn_bitshuffle_trap(data: bytes, type_size: int) -> None:
    """Steer users away from the known bitshuffle entropy floor.

    Bitshuffled float mantissas cap LZ match lengths at ~14 bytes, an
    entropy-structure floor ~2x slower than byte shuffle on typical f32
    data (measured profile: BASELINE.md "16 MiB f32 bitshuffle").  When
    the user forces --shuffle bit but the probe says byte shuffle has at
    least as much run structure, print a one-line stderr hint (the frame
    is still produced exactly as requested)."""
    try:
        rec = suggest_options(data, type_size=type_size)
    except BloscError:
        return
    if rec.shuffle != Shuffle.BITSHUFFLE:
        name = "byte shuffle" if rec.shuffle == Shuffle.SHUFFLE else "no shuffle"
        print(
            f"hint: the probe prefers {name} over bitshuffle for this data "
            "(first input probed; bitshuffle caps LZ match lengths on "
            "float-like streams — see README 'Choosing a filter'); pass "
            "--auto to use the probe's choice",
            file=sys.stderr,
        )


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        return _run(args)
    except BloscError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


def _run(args) -> int:

    if args.cmd == "compress":
        if args.output and len(args.input) > 1:
            print("error: -o/--output requires a single input file",
                  file=sys.stderr)
            return 2
        datas = []
        for path in args.input:
            with open(path, "rb") as f:
                datas.append(f.read())
        if not args.auto and args.shuffle == "bit":
            # probe OUTSIDE the timed region (it costs filter passes of
            # its own); first input only — the hint says so
            _warn_bitshuffle_trap(datas[0], args.typesize)
        t0 = time.perf_counter()
        if args.auto:
            # the probe picks codec+filter per file; level/block always
            # come from the flags (suggest_options never chooses a level)
            frames = []
            for data in datas:
                opts = suggest_options(data, type_size=args.typesize)
                opts = Options(
                    codec=opts.codec, level=args.level, shuffle=opts.shuffle,
                    type_size=opts.type_size, block_size=args.block,
                )
                frames.append(compress_with_options(data, opts))
        else:
            opts = Options(
                codec=_CODECS[args.codec], level=args.level,
                shuffle=_SHUFFLES[args.shuffle], type_size=args.typesize,
                block_size=args.block,
            )
            # one native crossing; small files parallelize across cores
            frames = compress_batch_with_options(datas, opts)
        dt = time.perf_counter() - t0
        for path, data, frame in zip(args.input, datas, frames):
            out = args.output or path + ".bl2"
            with open(out, "wb") as f:
                f.write(frame)
            print(
                f"{path}: {len(data):,} -> {len(frame):,} bytes "
                f"(ratio {len(data) / max(len(frame), 1):.2f}x) -> {out}"
            )
        total = sum(len(d) for d in datas)
        print(
            f"{len(datas)} file(s), {total:,} bytes in "
            f"{dt * 1e3:.1f} ms ({total / max(dt, 1e-9) / 1e9:.2f} GB/s)"
        )
        return 0

    if args.cmd == "decompress":
        if args.output and len(args.input) > 1:
            print("error: -o/--output requires a single input file",
                  file=sys.stderr)
            return 2
        frames = []
        for path in args.input:
            with open(path, "rb") as f:
                frames.append(f.read())
        t0 = time.perf_counter()
        datas = decompress_batch(frames)
        dt = time.perf_counter() - t0
        for path, frame, data in zip(args.input, frames, datas):
            out = args.output or path + ".out"
            with open(out, "wb") as f:
                f.write(data)
            print(f"{path}: {len(frame):,} -> {len(data):,} bytes -> {out}")
        total = sum(len(d) for d in datas)
        print(
            f"{len(frames)} file(s), {total:,} bytes in "
            f"{dt * 1e3:.1f} ms ({total / max(dt, 1e-9) / 1e9:.2f} GB/s)"
        )
        return 0

    if args.cmd == "info":
        with open(args.input, "rb") as f:
            frame = f.read()
        if frame[:4] == b"TPBA":
            # array envelope: report its metadata, then the inner frame's
            from .array import _parse_envelope
            from .dtypes import manifest_name

            dtype, shape, flags, off = _parse_envelope(frame)
            print(f"{args.input}: TPBA array envelope")
            print(f"  dtype: {manifest_name(dtype)}")
            print(f"  shape: {shape}")
            order = "F" if flags & 0x2 else "C"
            print(f"  order: {order}")
            if flags & 0x1:
                print("  payload: empty array (no frame)")
                return 0
            frame = frame[off:]
        h = get_info(frame)
        n = get_decompressed_size(frame)
        print(f"{args.input}:")
        for name, val in (
            ("kind", type(h).__name__),
            ("codec", getattr(h, "codec", None)),
            ("type_size", getattr(h, "type_size", None)),
            ("uncompressed", f"{n:,} bytes"),
            ("compressed", f"{len(frame):,} bytes"),
            ("ratio", f"{n / max(len(frame), 1):.2f}x"),
        ):
            print(f"  {name}: {val}")
        for flag in ("has_shuffle", "has_bitshuffle", "is_memcpy", "is_split"):
            v = getattr(h, flag, None)
            if v is not None:
                print(f"  {flag}: {v}")
        return 0

    if args.cmd == "suggest":
        with open(args.input, "rb") as f:
            data = f.read()
        opts = suggest_options(data, type_size=args.typesize)
        print(
            f"{args.input}: --codec {opts.codec.name.lower()} "
            f"--shuffle {'byte' if opts.shuffle == Shuffle.SHUFFLE else 'bit' if opts.shuffle == Shuffle.BITSHUFFLE else 'none'} "
            f"--typesize {opts.type_size}"
        )
        return 0

    if args.cmd == "pack":
        import numpy as np

        from .array import pack_array

        arr = np.load(args.input, allow_pickle=False)
        opts = Options(
            codec=_CODECS[args.codec], level=args.level,
            shuffle=_SHUFFLES[args.shuffle],
            type_size=min(arr.dtype.itemsize, 255),
        )
        packed = pack_array(arr, opts)
        out = args.output or args.input + ".tpba"
        with open(out, "wb") as f:
            f.write(packed)
        print(
            f"{args.input}: {arr.nbytes:,} -> {len(packed):,} bytes "
            f"(dtype {arr.dtype}, shape {arr.shape}) -> {out}"
        )
        return 0

    if args.cmd == "unpack":
        import numpy as np

        from .array import unpack_array

        with open(args.input, "rb") as f:
            tensor = unpack_array(f.read())
        try:
            arr = tensor.numpy()
        except TypeError:
            print(f"error: NumPy has no element type for {tensor.dtype}", file=sys.stderr)
            return 1
        out = args.output or args.input + ".npy"
        np.save(out, arr)
        print(
            f"{args.input}: dtype {arr.dtype}, shape {arr.shape}, "
            f"{arr.nbytes:,} bytes -> {out}"
        )
        return 0

    if args.cmd == "verify":
        from .stream import StreamReader

        with StreamReader(args.input) as r:
            count = r.verify(deep=args.deep)
            crc = "crc32-checked" if r._crc else "no checksums (flag off)"
        print(f"{args.input}: {count} records ok ({crc}"
              f"{', decoded' if args.deep else ''})")
        return 0

    return 2  # pragma: no cover - argparse enforces the choices


if __name__ == "__main__":
    sys.exit(main())
