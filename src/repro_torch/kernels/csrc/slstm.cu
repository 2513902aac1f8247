// sLSTM recurrence (xLSTM's scalar-memory cell) over [B, T, 4, D] gate
// pre-activations wx (gates z, i, f, o), recurrent weights R [D, 4, D] and
// bias b [4, D]:
//
//   pre = wx_t + h_{t-1} R + b
//   z = tanh(pre_0), i = pre_1, f = log_sigmoid(pre_2), o = sigmoid(pre_3)
//   m' = max(f + m, i)
//   c = e^{f+m-m'} c + e^{i-m'} z
//   n = e^{f+m-m'} n + e^{i-m'}
//   h = o c / max(n, 1e-6)
//
// returning y = h in wx's dtype and the final (h, c, n, m) in float32.
//
// Replaces the TPU kernel src/repro/kernels/slstm.py::_slstm_kernel
// (pallas_call at line 97, reached through slstm_scan). Held against the
// plain PyTorch version repro_torch/kernels/ref.py::slstm_ref: atol 1e-5
// in float32 up to T = 64 (the reference's own tolerance), 1e-4 at
// T = 512 and 2048, where the recurrence carries the difference in the
// summation order of h R; in bfloat16, y within one bf16 rounding.
//
// What bounds it: operations at long T. Each step is a [1, D] x [D, 4D]
// product per batch row, 2 * 4 * D^2 float operations, on R read once for
// the whole call: at (1, 2048, 768) with bf16 R that is 9.7 GFLOP against
// 36 MB, 0.14 ms of the card's float32 rate. At the decode shape
// (2, 1, 768) reading R (4.7 MB in bf16) bounds it, and a launch costs
// more than either.
//
// Design (simple first): one thread block per batch row walks all of T,
// so no grid-wide barrier is needed. h_{t-1} lives in shared memory, double
// buffered (step t reads one half and writes the other, one __syncthreads
// per step). A thread owns channels e = tid + j * blockDim (j < KPT: one
// channel at D <= 1024) with c, n and m in registers, and forms their four
// dot products sum_k h[k] R[k, g, e] one channel after the other, with
// neighbouring threads on neighbouring e, so every load of R is coalesced;
// R stays in the 50 MB L2 from step to step. Any B, T >= 1 and D <= 8192
// are taken; nothing is padded. The Pallas kernel instead holds R in VMEM
// and runs one MXU product per step; here one SM per batch row walks the
// sequence and streams all of R through its load path every step, far from
// the bound: splitting R's columns over a thread-block cluster with h
// exchanged through distributed shared memory is later work.
//
// Arithmetic is float32 with the CUDA math library's tanhf, expf and
// log1pf; log_sigmoid is the stable min(x, 0) - log1p(exp(-|x|)). The
// D-term sums are taken in blocks of 32 terms, each block summed in order
// and then added to the running sum. One sequential sum of all D terms
// rounds worse as D grows: at D = 3000 it left n 1.2e-5 farther from the
// float64 result than the plain version's library sum (measured on an
// H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxKpt = 8;
constexpr int kSumBlock = 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a torch cast
}

__device__ __forceinline__ float log_sigmoid(float v) {
  return fminf(v, 0.0f) - log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int KPT, typename TW, typename TR>
__global__ void __launch_bounds__(kMaxThreads)
slstm_kernel(const TW* __restrict__ wx, const TR* __restrict__ r,
             const TR* __restrict__ bg, const float* __restrict__ h0,
             const float* __restrict__ c0, const float* __restrict__ n0,
             const float* __restrict__ m0, TW* __restrict__ y,
             float* __restrict__ h_out, float* __restrict__ c_out,
             float* __restrict__ n_out, float* __restrict__ m_out,
             long long t_len, int d) {
  extern __shared__ float h_sh[];  // [2][d]: h_{t-1}, h_t
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long long row = static_cast<long long>(blockIdx.x) * d;
  const long long four_d = 4LL * d;
  float c[KPT], n[KPT], m[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int e = tid + j * nth;
    c[j] = n[j] = m[j] = 0.0f;
    if (e < d) {
      h_sh[e] = h0[row + e];
      c[j] = c0[row + e];
      n[j] = n0[row + e];
      m[j] = m0[row + e];
    }
  }
  __syncthreads();

  for (long long t = 0; t < t_len; ++t) {
    const float* hp = h_sh + (t & 1) * d;
    float* hn = h_sh + ((t + 1) & 1) * d;
    const long long step = row * t_len + t * d;  // (b, t) in [B, T, D]
    const TW* wxt = wx + 4 * step;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int e = tid + j * nth;
      if (e < d) {
        // sum_k h[k] R[k, g, e] in blocks of kSumBlock terms: each block
        // sequential with FMA, then added to the running sum
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const TR* re = r + e;
        for (int k0 = 0; k0 < d; k0 += kSumBlock) {
          const int k1 = min(k0 + kSumBlock, d);
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
          for (int k = k0; k < k1; ++k) {
            const float hk = hp[k];
            const TR* rk = re + k * four_d;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              part[g] = fmaf(hk, load_f32(rk + g * d), part[g]);
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g] += part[g];
        }
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          pre[g] = load_f32(wxt + g * d + e) + acc[g] +
                   load_f32(bg + g * d + e);
        }
        const float z = tanhf(pre[0]);
        const float i_t = pre[1];
        const float f_t = log_sigmoid(pre[2]);
        const float o = sigmoid(pre[3]);
        const float m_new = fmaxf(f_t + m[j], i_t);
        const float i_eff = expf(i_t - m_new);
        const float f_eff = expf(f_t + m[j] - m_new);
        c[j] = f_eff * c[j] + i_eff * z;
        n[j] = f_eff * n[j] + i_eff;
        m[j] = m_new;
        const float h = o * c[j] / fmaxf(n[j], 1e-6f);
        hn[e] = h;
        store(y + step + e, h);
      }
    }
    __syncthreads();
  }

  const float* h_last = h_sh + (t_len & 1) * d;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int e = tid + j * nth;
    if (e < d) {
      h_out[row + e] = h_last[e];
      c_out[row + e] = c[j];
      n_out[row + e] = n[j];
      m_out[row + e] = m[j];
    }
  }
}

template <int KPT, typename TW, typename TR>
int launch(const void* wx, const void* r, const void* bg, const float* h0,
           const float* c0, const float* n0, const float* m0, void* y,
           float* h_out, float* c_out, float* n_out, float* m_out, int batch,
           long long t_len, int d, cudaStream_t s) {
  const int per_thread = (d + KPT - 1) / KPT;
  const int threads = ((per_thread + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  auto kernel = slstm_kernel<KPT, TW, TR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, threads, smem, s>>>(
      static_cast<const TW*>(wx), static_cast<const TR*>(r),
      static_cast<const TR*>(bg), h0, c0, n0, m0, static_cast<TW*>(y), h_out,
      c_out, n_out, m_out, t_len, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW, typename TR>
int launch_kpt(const void* wx, const void* r, const void* bg, const float* h0,
               const float* c0, const float* n0, const float* m0, void* y,
               float* h_out, float* c_out, float* n_out, float* m_out,
               int batch, long long t_len, int d, cudaStream_t s) {
  if (d <= kMaxThreads) {
    return launch<1, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                             n_out, m_out, batch, t_len, d, s);
  }
  if (d <= 2 * kMaxThreads) {
    return launch<2, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                             n_out, m_out, batch, t_len, d, s);
  }
  if (d <= 4 * kMaxThreads) {
    return launch<4, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                             n_out, m_out, batch, t_len, d, s);
  }
  return launch<kMaxKpt, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                                 n_out, m_out, batch, t_len, d, s);
}

}  // namespace

// Launch on `stream`; returns a cudaError_t as an int (0 = launched).
// wx: contiguous [batch, t_len, 4, d], float (wx_bf16 = 0) or bfloat16
// (wx_bf16 = 1); y: [batch, t_len, d] of wx's type; r: [d, 4, d] and
// b: [4, d], float (r_bf16 = 0) or bfloat16 (r_bf16 = 1); h0, c0, n0, m0
// and the four outputs: float [batch, d]. 1 <= d <= 8192.
extern "C" int slstm_launch(const void* wx, const void* r, const void* b,
                            const void* h0, const void* c0, const void* n0,
                            const void* m0, void* y, void* h_out, void* c_out,
                            void* n_out, void* m_out, int batch,
                            long long t_len, int d, int wx_bf16, int r_bf16,
                            void* stream) {
  if (batch < 1 || t_len < 1 || d < 1 || d > kMaxKpt * kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  const float* ni = static_cast<const float*>(n0);
  const float* mi = static_cast<const float*>(m0);
  float* ho = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  float* no = static_cast<float*>(n_out);
  float* mo = static_cast<float*>(m_out);
  if (wx_bf16 && r_bf16) {
    return launch_kpt<__nv_bfloat16, __nv_bfloat16>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, batch, t_len, d, s);
  }
  if (wx_bf16) {
    return launch_kpt<__nv_bfloat16, float>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, batch, t_len, d, s);
  }
  if (r_bf16) {
    return launch_kpt<float, __nv_bfloat16>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, batch, t_len, d, s);
  }
  return launch_kpt<float, float>(wx, r, b, hi, ci, ni, mi, y, ho, co, no,
                                  mo, batch, t_len, d, s);
}
