// RG-LRU recurrence (Griffin / RecurrentGemma) over [B, T, D] gate tensors:
//
//   a_t = exp(-c * softplus(log_lambda) * sigmoid(r_t))
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * sigmoid(i_t) * x_t
//
// returning y = h in the input dtype and h_T in float32.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_rglru_kernel
// (pallas_call at line 79, reached through rglru / kernels.ops.rglru_scan).
// Held against the plain PyTorch version repro_torch/kernels/ref.py::
// rglru_ref: atol 1e-5 in float32; in bfloat16, h_T at atol 1e-5 and y
// within one bf16 rounding.
//
// What bounds it: bytes. Per element it does about 16 float operations
// (three exponentials among them) on 3 values read and 1 written, far below
// the H100's operations-per-byte balance, so the least time is
// (4 * B*T*D * itemsize + 4 * B*D for h_T [+ 4 * B*D for h0] + 4 * D) over
// the memory rate. At the decode shape (2, 1, 4096) that is about 0.05 us:
// a launch costs more than the work.
//
// Design: the recurrence is elementwise over channels and sequential over
// time. The Pallas kernel walks time blocks on a sequential grid axis with
// h carried in VMEM scratch; here one thread owns one (b, d) channel and
// walks all of T with h in a register, so nothing is carried between
// blocks and no shared memory is needed. Neighbouring threads own
// neighbouring d, so each time step's loads of x, r, i and the store of y
// are coalesced. Any T >= 1 and any D are taken (the ragged last block is
// masked); there are no block_t / block_d divisibility rules. It keeps
// decode and T below repro_torch/kernels/rglru.py::SM90_MIN_T, where its
// few steps cost less than a pipeline start; longer T goes to
// csrc/rglru_sm90.cu (channel tiles on every SM), which repeats this
// kernel's arithmetic to the bit.
//
// Rounding: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: nvcc never fuses them into an FMA), in the plain version's
// order, with the CUDA math library's expf/log1pf/sqrtf, so it repeats the
// plain version's arithmetic on the card as far as PyTorch's elementwise
// kernels use those same functions. Where a = 1 - eps with eps small, a
// fused 1 - a*a would shift sqrt(1 - a^2) by a relative eps-sized amount
// that the recurrence then carries for about 1/eps steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a torch cast
}

// jax.nn.softplus is logaddexp(v, 0): no switch to the identity at large v
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <typename T>
__global__ void rglru_kernel(const T* __restrict__ x, const T* __restrict__ r,
                             const T* __restrict__ i,
                             const float* __restrict__ log_lambda,
                             const float* __restrict__ h0, T* __restrict__ y,
                             float* __restrict__ h_out, int batch,
                             long long t_len, int d, float c) {
  const long long ch = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (ch >= static_cast<long long>(batch) * d) return;
  const long long b = ch / d;
  const int dd = static_cast<int>(ch % d);
  const float neg_c_decay = __fmul_rn(-c, softplus(log_lambda[dd]));
  float h = h0 != nullptr ? h0[ch] : 0.0f;
  long long off = b * t_len * d + dd;
#pragma unroll 4
  for (long long t = 0; t < t_len; ++t, off += d) {
    const float a = expf(__fmul_rn(neg_c_decay, sigmoid(load_f32(r + off))));
    const float gated = __fmul_rn(sigmoid(load_f32(i + off)), load_f32(x + off));
    const float mult = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 1e-12f));
    h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(mult, gated));
    store(y + off, h);
  }
  h_out[ch] = h;
}

template <typename T>
void launch(const void* x, const void* r, const void* i, const float* ll,
            const float* h0, void* y, float* h_out, int batch,
            long long t_len, int d, float c, cudaStream_t s) {
  const int threads = 256;
  const long long channels = static_cast<long long>(batch) * d;
  const unsigned blocks = static_cast<unsigned>((channels + threads - 1) / threads);
  rglru_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(i), ll, h0, static_cast<T*>(y), h_out, batch,
      t_len, d, c);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
// x, r, i, y: contiguous [batch, t_len, d] of float (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); log_lambda: float [d]; h0: float [batch, d] or
// null (zero state); h_out: float [batch, d].
extern "C" int rglru_launch(const void* x, const void* r, const void* i,
                            const void* log_lambda, const void* h0, void* y,
                            void* h_out, int batch, long long t_len, int d,
                            int is_bf16, float c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ll = static_cast<const float*>(log_lambda);
  const float* h_in = static_cast<const float*>(h0);
  float* h_o = static_cast<float*>(h_out);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, r, i, ll, h_in, y, h_o, batch, t_len, d, c, s);
  } else {
    launch<float>(x, r, i, ll, h_in, y, h_o, batch, t_len, d, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
