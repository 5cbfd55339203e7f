/* Declarations of the libzstd functions that tpu_blosc/native/tpublosc.cpp
 * calls, taken from zstd's stable public API (unchanged since zstd 1.3).
 *
 * The port compiles that C++ source in place and links it against the
 * runtime library libzstd.so.1.  Hosts that carry the runtime library but
 * not its development header can build it all the same; the codec and the
 * library it calls are unchanged.  Nothing here defines behaviour.
 */
#ifndef TPU_BLOSC_TORCH_ZSTD_DECLS_H
#define TPU_BLOSC_TORCH_ZSTD_DECLS_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

size_t ZSTD_compress(void *dst, size_t dstCapacity, const void *src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);
unsigned long long ZSTD_getFrameContentSize(const void *src, size_t srcSize);
size_t ZSTD_findFrameCompressedSize(const void *src, size_t srcSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);

ZSTD_CCtx *ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx *cctx);
size_t ZSTD_compressCCtx(ZSTD_CCtx *cctx, void *dst, size_t dstCapacity,
                         const void *src, size_t srcSize,
                         int compressionLevel);

ZSTD_DCtx *ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx *dctx);
size_t ZSTD_decompressDCtx(ZSTD_DCtx *dctx, void *dst, size_t dstCapacity,
                           const void *src, size_t srcSize);

#ifdef __cplusplus
}
#endif

#endif /* TPU_BLOSC_TORCH_ZSTD_DECLS_H */
