// The IIR filter's C entries and its float64 instantiations; the kernels
// and their design are in iir.cuh, the float32 instantiations in
// iir_f32.cu.

#include "iir.cuh"

extern "C" int runmat_iir_f32(int ncoef, const void* x, void* y, int64_t n,
                              int lg_chunk, const void* b, const void* a,
                              const void* z0, void* scratch, int upto,
                              void* stream);

namespace {

bool valid(int dtype, int64_t n, int ncoef, int lg_chunk) {
  return (dtype == 0 || dtype == 1) && ncoef >= 2 && ncoef <= kMaxN &&
         n >= 0 && lg_chunk >= 0 && lg_chunk <= kMaxLgChunk;
}

}  // namespace

// Bytes of scratch a call needs (0 for a single stretch), or -1 where the
// arguments are refused.
extern "C" int64_t runmat_iir_scratch(int dtype, int64_t n, int ncoef,
                                      int lg_chunk) {
  if (!valid(dtype, n, ncoef, lg_chunk)) return -1;
  return layout(n, ncoef - 1, lg_chunk).bytes;
}

// dtype 0: float32, 1: float64. x, y: n values; b, a: ncoef values (a[0]
// is 1 and not read); z0: ncoef - 1 values; stretches of 2^lg_chunk
// samples; scratch: runmat_iir_scratch(...) bytes, 256-byte aligned. All
// on `device`, contiguous. `upto` < 4 stops after that phase (timing).
extern "C" int runmat_iir(int dtype, const void* x, void* y, int64_t n,
                          int ncoef, const void* b, const void* a,
                          const void* z0, int lg_chunk, void* scratch,
                          int64_t scratch_bytes, int upto, void* stream,
                          int device) {
  if (!valid(dtype, n, ncoef, lg_chunk) ||
      scratch_bytes < runmat_iir_scratch(dtype, n, ncoef, lg_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return runmat_iir_f32(ncoef, x, y, n, lg_chunk, b, a, z0, scratch, upto,
                          stream);
  return static_cast<int>(dispatch<F64, 2>(ncoef, x, y, n, lg_chunk, b, a,
                                           z0, scratch, upto, s));
}
