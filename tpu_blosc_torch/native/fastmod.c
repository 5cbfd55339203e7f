/* _tpbfast: CPython fastcall bindings for the single-block frame hot path.
 *
 * The ctypes crossing costs ~2-3 us per call in argument marshalling plus
 * a staging memmove and a second allocation — measurable against the
 * ~9 us C-side cost of the reference's own 100 KB benchmark config
 * (blosc_test.go:363-413).  This module is a METH_FASTCALL front door to
 * the same tpb_* entry points (linked against libtpublosc.so, rpath
 * $ORIGIN): one Python call, one C call, one PyBytes allocation.
 *
 * Falls back transparently: native/backend.py only imports this module
 * when it built successfully; everything below is also reachable via the
 * ctypes path (oracle-equality tests run both).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* entry points from tpublosc.cpp (extern "C" there) */
extern int64_t tpb_compress_frame(const uint8_t *src, int64_t n, int ts,
                                  int shuffle_mode, int header_codec_id,
                                  int codec, int depth, uint8_t *dst);
extern int64_t tpb_decompress_block_into(const uint8_t *frame,
                                         int64_t payload_off, int64_t psize,
                                         uint8_t *out, int64_t n, int ts,
                                         int shuffle_mode, int codec);

/* per-thread staging buffer for compressed output (bound-sized, reused) */
static _Thread_local uint8_t *stage = NULL;
static _Thread_local int64_t stage_cap = 0;

static uint8_t *get_stage(int64_t need) {
  if (stage_cap < need) {
    int64_t cap = need < (1 << 17) ? (1 << 17) : need;
    uint8_t *nb = (uint8_t *)realloc(stage, (size_t)cap);
    if (!nb) return NULL;
    stage = nb;
    stage_cap = cap;
  }
  return stage;
}

/* compress_frame(data: bytes-like, type_size, shuffle_mode, header_codec,
 *                native_codec, depth) -> bytes (complete frame)
 * Raises RuntimeError on negative native status (parity with
 * backend.compress_frame). */
static PyObject *fast_compress_frame(PyObject *self, PyObject *const *args,
                                     Py_ssize_t nargs) {
  (void)self;
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError, "compress_frame expects 6 arguments");
    return NULL;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(args[0], &view, PyBUF_SIMPLE) < 0) return NULL;
  long ts = PyLong_AsLong(args[1]);
  long shuf = PyLong_AsLong(args[2]);
  long hdr_codec = PyLong_AsLong(args[3]);
  long codec = PyLong_AsLong(args[4]);
  long depth = PyLong_AsLong(args[5]);
  if (PyErr_Occurred()) {
    PyBuffer_Release(&view);
    return NULL;
  }
  int64_t n = (int64_t)view.len;
  /* same conservative universal bound as backend._universal_bound */
  uint8_t *dst = get_stage(16 + n + (n >> 2) + 1024);
  if (!dst) {
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
  }
  int64_t total;
  Py_BEGIN_ALLOW_THREADS;
  total = tpb_compress_frame((const uint8_t *)view.buf, n, (int)ts, (int)shuf,
                             (int)hdr_codec, (int)codec, (int)depth, dst);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&view);
  if (total < 0) {
    PyErr_Format(PyExc_RuntimeError, "native compress_frame failed (%lld)",
                 (long long)total);
    return NULL;
  }
  return PyBytes_FromStringAndSize((const char *)dst, (Py_ssize_t)total);
}

/* decompress_frame(data, payload_off, psize, nbytes_orig, type_size,
 *                  shuffle_mode, native_codec) -> bytes | int
 * Returns the decoded bytes on success; on failure returns the native
 * status (int) — the cold error path maps codes to typed exceptions in
 * Python where the error strings live. */
static PyObject *fast_decompress_frame(PyObject *self, PyObject *const *args,
                                       Py_ssize_t nargs) {
  (void)self;
  if (nargs != 7) {
    PyErr_SetString(PyExc_TypeError, "decompress_frame expects 7 arguments");
    return NULL;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(args[0], &view, PyBUF_SIMPLE) < 0) return NULL;
  long long off = PyLong_AsLongLong(args[1]);
  long long psize = PyLong_AsLongLong(args[2]);
  long long n = PyLong_AsLongLong(args[3]);
  long ts = PyLong_AsLong(args[4]);
  long shuf = PyLong_AsLong(args[5]);
  long codec = PyLong_AsLong(args[6]);
  if (PyErr_Occurred() || n < 0 || off < 0 || psize < 0 ||
      off + psize > (long long)view.len) {
    PyBuffer_Release(&view);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "payload out of range");
    return NULL;
  }
  PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n);
  if (!out) {
    PyBuffer_Release(&view);
    return NULL;
  }
  int64_t got;
  Py_BEGIN_ALLOW_THREADS;
  got = tpb_decompress_block_into((const uint8_t *)view.buf, off, psize,
                                  (uint8_t *)PyBytes_AS_STRING(out), n,
                                  (int)ts, (int)shuf, (int)codec);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&view);
  if (got == n) return out;
  Py_DECREF(out);
  return PyLong_FromLongLong((long long)got);
}

/* ---- batch entry points --------------------------------------------------
 * One Python call for N independent frames: the per-call Python+binding
 * overhead (~1.5 us) and the GIL round-trip are paid once per batch, and
 * the native side schedules whole small frames across the SpinPool (see
 * tpb_compress_batch in tpublosc.cpp).  Output bytes are identical to
 * per-frame calls. */

extern void tpb_compress_batch(const uint8_t *const *srcs, const int64_t *ns,
                               int64_t nf, int ts, int shuffle_mode,
                               int header_codec_id, int codec, int depth,
                               uint8_t *const *dsts, int64_t *results,
                               int64_t *idx_buf);
extern void tpb_decompress_batch(const uint8_t *const *frames,
                                 const int64_t *psizes, const int64_t *ns,
                                 const int32_t *tss, const int32_t *modes,
                                 const int32_t *codecs, int64_t nf,
                                 uint8_t *const *outs, int64_t *results,
                                 int64_t *idx_buf);

/* compress_batch(items: sequence of bytes-like, type_size, shuffle_mode,
 *                header_codec, native_codec, depth) -> list[bytes]
 * Every item must be non-empty (the Python wrapper enforces the typed
 * error first).  Raises RuntimeError on any per-frame native failure. */
static PyObject *fast_compress_batch(PyObject *self, PyObject *const *args,
                                     Py_ssize_t nargs) {
  (void)self;
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError, "compress_batch expects 6 arguments");
    return NULL;
  }
  long ts = PyLong_AsLong(args[1]);
  long shuf = PyLong_AsLong(args[2]);
  long hdr_codec = PyLong_AsLong(args[3]);
  long codec = PyLong_AsLong(args[4]);
  long depth = PyLong_AsLong(args[5]);
  if (PyErr_Occurred()) return NULL;
  PyObject *seq = PySequence_Fast(args[0], "compress_batch needs a sequence");
  if (!seq) return NULL;
  Py_ssize_t nf = PySequence_Fast_GET_SIZE(seq);
  PyObject *out_list = PyList_New(nf);
  if (!out_list || nf == 0) {
    Py_DECREF(seq);
    return out_list;
  }
  /* one carve-out block for all the per-frame arrays */
  size_t arr_bytes = (size_t)nf * (4 * sizeof(void *) + sizeof(Py_buffer));
  char *blk = (char *)malloc(arr_bytes);
  if (!blk) {
    Py_DECREF(seq);
    Py_DECREF(out_list);
    return PyErr_NoMemory();
  }
  const uint8_t **srcs = (const uint8_t **)blk;
  int64_t *ns = (int64_t *)(srcs + nf);
  uint8_t **dsts = (uint8_t **)(ns + nf);
  int64_t *results = (int64_t *)(dsts + nf);
  Py_buffer *views = (Py_buffer *)(results + nf);
  int64_t *idx = (int64_t *)malloc((size_t)nf * sizeof(int64_t));
  Py_ssize_t nviews = 0;
  int failed = 0;
  if (!idx) {
    PyErr_NoMemory();
    failed = 1;
  }
  for (Py_ssize_t i = 0; !failed && i < nf; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[i], PyBUF_SIMPLE) < 0) {
      failed = 1;
      break;
    }
    nviews = i + 1;
    int64_t n = (int64_t)views[i].len;
    srcs[i] = (const uint8_t *)views[i].buf;
    ns[i] = n;
    /* bound-sized result object, shrunk in place after the encode */
    int64_t cap = 16 + n + (n >> 2) + 1024;
    PyObject *ob = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)cap);
    if (!ob) {
      failed = 1;
      break;
    }
    dsts[i] = (uint8_t *)PyBytes_AS_STRING(ob);
    PyList_SET_ITEM(out_list, i, ob); /* steals ref */
  }
  if (!failed) {
    Py_BEGIN_ALLOW_THREADS;
    tpb_compress_batch(srcs, ns, (int64_t)nf, (int)ts, (int)shuf,
                       (int)hdr_codec, (int)codec, (int)depth, dsts, results,
                       idx);
    Py_END_ALLOW_THREADS;
    for (Py_ssize_t i = 0; i < nf; i++) {
      if (results[i] < 0) {
        PyErr_Format(PyExc_RuntimeError,
                     "native compress_frame failed (%lld) at batch index %zd",
                     (long long)results[i], i);
        failed = 1;
        break;
      }
      PyObject *ob = PyList_GET_ITEM(out_list, i);
      if (_PyBytes_Resize(&ob, (Py_ssize_t)results[i]) < 0) {
        /* ob already decref'd by _PyBytes_Resize on failure */
        PyList_SET_ITEM(out_list, i, Py_None);
        Py_INCREF(Py_None);
        failed = 1;
        break;
      }
      PyList_SET_ITEM(out_list, i, ob); /* may have moved */
    }
  }
  for (Py_ssize_t i = 0; i < nviews; i++) PyBuffer_Release(&views[i]);
  free(idx);
  free(blk);
  Py_DECREF(seq);
  if (failed) {
    Py_DECREF(out_list);
    return NULL;
  }
  return out_list;
}

/* Parse + eligibility mirror of the scalar fast path (api.py:198-211),
 * shared by both batch decoders so the single-block rules (version byte,
 * FLAG_SPLIT|FLAG_MEMCPY, native codec map, size sanity, shuffle-mode
 * precedence) live in exactly one place.  Returns 1 and fills the out
 * params when the frame can take the native batch path. */
static int parse_batch_frame(const uint8_t *b, int64_t blen, const char *map,
                             long ts_override, int64_t *psize, int64_t *n,
                             int32_t *ts, int32_t *mode, int32_t *codec) {
  if (blen <= 16 || b[0] != 2) return 0;
  uint8_t codec_id = b[1], flags = b[2], ts_hdr = b[3];
  if (flags & (0x8 | 0x2)) return 0; /* FLAG_SPLIT | FLAG_MEMCPY */
  if (codec_id >= 6 || (uint8_t)map[codec_id] == 0xFF) return 0;
  uint32_t n_orig, n_comp;
  memcpy(&n_orig, b + 4, 4);
  memcpy(&n_comp, b + 12, 4);
  if (n_comp <= 16 || (int64_t)n_comp > blen || n_orig == 0) return 0;
  *psize = (int64_t)n_comp - 16;
  *n = (int64_t)n_orig;
  *ts = ts_override > 0 ? (int32_t)ts_override : (int32_t)ts_hdr;
  *mode = (flags & 0x4) ? 2 : (flags & 0x1) ? 1 : 0;
  *codec = (int32_t)(uint8_t)map[codec_id];
  return 1;
}

/* decompress_batch(items, type_size, native_map: bytes[6]) -> list
 * Each result is the decoded bytes, or None when the frame is not
 * eligible for the native single-block fast path or failed decoding —
 * the Python wrapper re-runs those through the scalar path, which owns
 * every error message and the registry override (api.py:198-211 mirror).
 * native_map[codec_id] is the native codec id, 0xFF = not native. */
static PyObject *fast_decompress_batch(PyObject *self, PyObject *const *args,
                                       Py_ssize_t nargs) {
  (void)self;
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "decompress_batch expects 3 arguments");
    return NULL;
  }
  long ts_override = PyLong_AsLong(args[1]);
  if (PyErr_Occurred()) return NULL;
  char *map;
  Py_ssize_t map_len;
  if (PyBytes_AsStringAndSize(args[2], &map, &map_len) < 0) return NULL;
  if (map_len < 6) {
    PyErr_SetString(PyExc_ValueError, "native_map must have 6 entries");
    return NULL;
  }
  PyObject *seq = PySequence_Fast(args[0], "decompress_batch needs a sequence");
  if (!seq) return NULL;
  Py_ssize_t nf = PySequence_Fast_GET_SIZE(seq);
  PyObject *out_list = PyList_New(nf);
  if (!out_list || nf == 0) {
    Py_DECREF(seq);
    return out_list;
  }
  size_t arr_bytes = (size_t)nf * (2 * sizeof(void *) + 4 * sizeof(int64_t) +
                                   3 * sizeof(int32_t) + sizeof(Py_buffer) +
                                   sizeof(Py_ssize_t));
  char *blk = (char *)malloc(arr_bytes);
  if (!blk) {
    Py_DECREF(seq);
    Py_DECREF(out_list);
    return PyErr_NoMemory();
  }
  /* 8-byte-aligned arrays first; the int32 trio last (keeps Py_buffer
   * aligned for any nf) */
  const uint8_t **frames = (const uint8_t **)blk;
  uint8_t **outs = (uint8_t **)(frames + nf);
  int64_t *psizes = (int64_t *)(outs + nf);
  int64_t *ns = (int64_t *)(psizes + nf);
  int64_t *results = (int64_t *)(ns + nf);
  int64_t *idx = (int64_t *)(results + nf);
  Py_buffer *views = (Py_buffer *)(idx + nf);
  Py_ssize_t *orig = (Py_ssize_t *)(views + nf); /* eligible j -> item i */
  int32_t *tss = (int32_t *)(orig + nf);
  int32_t *modes = tss + nf;
  int32_t *codecs = modes + nf;
  Py_ssize_t nviews = 0, nel = 0;
  int failed = 0;
  for (Py_ssize_t i = 0; i < nf; i++) {
    /* default: punt to Python */
    Py_INCREF(Py_None);
    PyList_SET_ITEM(out_list, i, Py_None);
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[nviews], PyBUF_SIMPLE) < 0) {
      failed = 1;
      break;
    }
    const uint8_t *b = (const uint8_t *)views[nviews].buf;
    int64_t blen = (int64_t)views[nviews].len;
    nviews++;
    int64_t psize, dn;
    int32_t ts, mode, codec;
    if (!parse_batch_frame(b, blen, map, ts_override, &psize, &dn, &ts,
                           &mode, &codec))
      continue;
    PyObject *ob = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)dn);
    if (!ob) {
      failed = 1;
      break;
    }
    Py_ssize_t j = nel++;
    frames[j] = b;
    outs[j] = (uint8_t *)PyBytes_AS_STRING(ob);
    psizes[j] = psize;
    ns[j] = dn;
    tss[j] = ts;
    modes[j] = mode;
    codecs[j] = codec;
    orig[j] = i;
    PyObject *prev = PyList_GET_ITEM(out_list, i);
    PyList_SET_ITEM(out_list, i, ob); /* replace the None (steals ref) */
    Py_DECREF(prev);
  }
  if (!failed && nel > 0) {
    Py_BEGIN_ALLOW_THREADS;
    tpb_decompress_batch(frames, psizes, ns, tss, modes, codecs, (int64_t)nel,
                         outs, results, idx);
    Py_END_ALLOW_THREADS;
    for (Py_ssize_t j = 0; j < nel; j++) {
      if (results[j] != ns[j]) {
        /* wrong size / malformed: hand the item back to Python for the
         * typed error (or the rare success via a non-fast path) */
        PyObject *prev = PyList_GET_ITEM(out_list, orig[j]);
        Py_INCREF(Py_None);
        PyList_SET_ITEM(out_list, orig[j], Py_None);
        Py_DECREF(prev);
      }
    }
  }
  for (Py_ssize_t i = 0; i < nviews; i++) PyBuffer_Release(&views[i]);
  free(blk);
  Py_DECREF(seq);
  if (failed) {
    Py_DECREF(out_list);
    return NULL;
  }
  return out_list;
}

/* decompress_batch_into(items, outs, type_size, native_map) -> list
 * Zero-copy batch decode: eligible frames decode straight into the
 * caller's writable buffers (outs[i].nbytes >= the frame's NBytesOrig).
 * Result entries are the byte count written (int) or None when the item
 * punts to the scalar Python path (ineligible frame, undersized buffer,
 * or a payload that failed to decode — out may then hold partial data,
 * same as the scalar contract's failure mode). */
static PyObject *fast_decompress_batch_into(PyObject *self,
                                            PyObject *const *args,
                                            Py_ssize_t nargs) {
  (void)self;
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError,
                    "decompress_batch_into expects 4 arguments");
    return NULL;
  }
  long ts_override = PyLong_AsLong(args[2]);
  if (PyErr_Occurred()) return NULL;
  char *map;
  Py_ssize_t map_len;
  if (PyBytes_AsStringAndSize(args[3], &map, &map_len) < 0) return NULL;
  if (map_len < 6) {
    PyErr_SetString(PyExc_ValueError, "native_map must have 6 entries");
    return NULL;
  }
  PyObject *seq = PySequence_Fast(args[0], "decompress_batch_into frames");
  if (!seq) return NULL;
  PyObject *oseq = PySequence_Fast(args[1], "decompress_batch_into outs");
  if (!oseq) {
    Py_DECREF(seq);
    return NULL;
  }
  Py_ssize_t nf = PySequence_Fast_GET_SIZE(seq);
  if (PySequence_Fast_GET_SIZE(oseq) != nf) {
    Py_DECREF(seq);
    Py_DECREF(oseq);
    PyErr_SetString(PyExc_ValueError, "outs length must match items");
    return NULL;
  }
  PyObject *out_list = PyList_New(nf);
  if (!out_list || nf == 0) {
    Py_DECREF(seq);
    Py_DECREF(oseq);
    return out_list;
  }
  size_t arr_bytes = (size_t)nf * (2 * sizeof(void *) + 4 * sizeof(int64_t) +
                                   3 * sizeof(int32_t) + 2 * sizeof(Py_buffer) +
                                   sizeof(Py_ssize_t));
  char *blk = (char *)malloc(arr_bytes);
  if (!blk) {
    Py_DECREF(seq);
    Py_DECREF(oseq);
    Py_DECREF(out_list);
    return PyErr_NoMemory();
  }
  const uint8_t **frames = (const uint8_t **)blk;
  uint8_t **outs = (uint8_t **)(frames + nf);
  int64_t *psizes = (int64_t *)(outs + nf);
  int64_t *ns = (int64_t *)(psizes + nf);
  int64_t *results = (int64_t *)(ns + nf);
  int64_t *idx = (int64_t *)(results + nf);
  Py_buffer *views = (Py_buffer *)(idx + nf); /* 2*nf: frame + out pairs */
  Py_ssize_t *orig = (Py_ssize_t *)(views + 2 * nf);
  int32_t *tss = (int32_t *)(orig + nf);
  int32_t *modes = tss + nf;
  int32_t *codecs = modes + nf;
  Py_ssize_t nviews = 0, nel = 0;
  int failed = 0;
  for (Py_ssize_t i = 0; i < nf; i++) {
    Py_INCREF(Py_None);
    PyList_SET_ITEM(out_list, i, Py_None);
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[nviews], PyBUF_SIMPLE) < 0) {
      failed = 1;
      break;
    }
    const uint8_t *b = (const uint8_t *)views[nviews].buf;
    int64_t blen = (int64_t)views[nviews].len;
    nviews++;
    int64_t psize, dn;
    int32_t ts, mode, codec;
    if (!parse_batch_frame(b, blen, map, ts_override, &psize, &dn, &ts,
                           &mode, &codec))
      continue;
    PyObject *ob = PySequence_Fast_GET_ITEM(oseq, i);
    if (PyObject_GetBuffer(ob, &views[nviews], PyBUF_WRITABLE) < 0) {
      PyErr_Clear(); /* read-only buffer: scalar path raises the error */
      continue;
    }
    if ((int64_t)views[nviews].len < dn) {
      PyBuffer_Release(&views[nviews]); /* undersized: scalar raises */
      continue;
    }
    uint8_t *outp = (uint8_t *)views[nviews].buf;
    nviews++;
    Py_ssize_t j = nel++;
    frames[j] = b;
    outs[j] = outp;
    psizes[j] = psize;
    ns[j] = dn;
    tss[j] = ts;
    modes[j] = mode;
    codecs[j] = codec;
    orig[j] = i;
  }
  if (!failed && nel > 0) {
    Py_BEGIN_ALLOW_THREADS;
    tpb_decompress_batch(frames, psizes, ns, tss, modes, codecs, (int64_t)nel,
                         outs, results, idx);
    Py_END_ALLOW_THREADS;
    for (Py_ssize_t j = 0; j < nel; j++) {
      if (results[j] != ns[j]) continue; /* stays None -> scalar path */
      PyObject *count = PyLong_FromLongLong((long long)ns[j]);
      if (!count) {
        failed = 1;
        break;
      }
      PyObject *prev = PyList_GET_ITEM(out_list, orig[j]);
      PyList_SET_ITEM(out_list, orig[j], count);
      Py_DECREF(prev);
    }
  }
  for (Py_ssize_t i = 0; i < nviews; i++) PyBuffer_Release(&views[i]);
  free(blk);
  Py_DECREF(seq);
  Py_DECREF(oseq);
  if (failed) {
    Py_DECREF(out_list);
    return NULL;
  }
  return out_list;
}

static PyMethodDef methods[] = {
    {"compress_frame", (PyCFunction)(void (*)(void))fast_compress_frame,
     METH_FASTCALL, "single-shot frame compress"},
    {"decompress_frame", (PyCFunction)(void (*)(void))fast_decompress_frame,
     METH_FASTCALL, "single-shot frame decompress"},
    {"decompress_batch_into", (PyCFunction)(void (*)(void))
     fast_decompress_batch_into,
     METH_FASTCALL, "batch single-block frame decode into caller buffers"},
    {"compress_batch", (PyCFunction)(void (*)(void))fast_compress_batch,
     METH_FASTCALL, "batch single-block frame compress"},
    {"decompress_batch", (PyCFunction)(void (*)(void))fast_decompress_batch,
     METH_FASTCALL, "batch single-block frame decompress"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tpbfast", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__tpbfast(void) { return PyModule_Create(&moduledef); }
