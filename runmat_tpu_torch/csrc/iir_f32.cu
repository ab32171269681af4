// The IIR filter's float32 instantiations (see iir.cuh), called by
// runmat_iir in iir.cu with arguments it has checked.

#include "iir.cuh"

extern "C" int runmat_iir_f32(int ncoef, const void* x, void* y, int64_t n,
                              int lg_chunk, const void* b, const void* a,
                              const void* z0, void* scratch, int upto,
                              void* stream) {
  return static_cast<int>(dispatch<F32, 2>(ncoef, x, y, n, lg_chunk, b, a,
                                           z0, scratch, upto,
                                           static_cast<cudaStream_t>(stream)));
}
