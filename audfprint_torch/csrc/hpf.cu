// Kernel K2: the causal onset high-pass filter along time,
//   y[t] = (x[t] - x[t-1]) + pole * y[t-1],
// over a (B, T, F) float32 spectrogram, with an optional carry:
// (x[-1], y[-1]) are read from x0/y0 (each (B, F)) or are zero when those
// pointers are null, and (x[T-1], y[T-1]) are written to xT/yT when those
// are not null.  Chaining the carry over consecutive chunks of T gives
// exactly the one-pass result (streamed ingest, ops/streaming.py).
//
// Replaces: audfprint_tpu/ops/spectro.py hpf and the scan of
// audfprint_tpu/ops/streaming.py chunk_fwd_peaks (lax.scans that XLA runs
// outside any Pallas kernel).  PyTorch has no scan primitive, and a Python
// loop over T issues about three launches per frame.
//
// What bounds it: the serial recurrence over T.  Each (row, bin) column is
// independent, so one thread owns one column and walks t; neighbouring
// threads own neighbouring bins, so every load and store of a frame is
// coalesced.  Bytes moved are 2 * B * T * F * 4; the loads do not depend on
// the recurrence, so unrolling lets them issue ahead of the chain.
//
// Bit-exactness: the reference (XLA on the CPU) contracts the recurrence
// into one fused multiply-add, y = fma(pole, y[t-1], x[t] - x[t-1]), with
// the difference rounded first.  The _rn intrinsics pin exactly that
// rounding sequence, whatever nvcc's own contraction flags are; the plain
// version (ops/spectro.py hpf_plain) forms the same single rounding.

#include <cuda_runtime.h>

__global__ void hpf_scan_kernel(const float* __restrict__ x,
                                float* __restrict__ y,
                                const float* __restrict__ x0,
                                const float* __restrict__ y0,
                                float* __restrict__ xT,
                                float* __restrict__ yT,
                                int B, int T, int F, float pole) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (long long)B * F) return;
  const long long b = col / F;
  const long long f = col % F;
  const float* xp = x + b * T * F + f;
  float* yp = y + b * T * F + f;
  float xprev = x0 ? x0[col] : 0.0f;
  float yprev = y0 ? y0[col] : 0.0f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float xv = xp[(long long)t * F];
    const float yv = __fmaf_rn(pole, yprev, __fsub_rn(xv, xprev));
    yp[(long long)t * F] = yv;
    xprev = xv;
    yprev = yv;
  }
  if (xT) xT[col] = xprev;
  if (yT) yT[col] = yprev;
}

extern "C" int hpf_scan(const float* x, float* y, const float* x0,
                        const float* y0, float* xT, float* yT, int B, int T,
                        int F, float pole, void* stream) {
  const long long n = (long long)B * F;
  if (n > 0 && T > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    hpf_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        x, y, x0, y0, xT, yT, B, T, F, pole);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* audfp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
