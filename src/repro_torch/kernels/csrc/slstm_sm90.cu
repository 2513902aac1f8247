// sLSTM recurrence (xLSTM's scalar-memory cell) on a persistent grid with R
// resident in shared memory, over [B, T, 4, D] gate pre-activations wx
// (gates z, i, f, o), recurrent weights R [D, 4, D] and bias b [4, D]:
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
// (pallas_call at line 97, reached through slstm_scan), which keeps R in
// VMEM for the whole sequence. Held against the plain PyTorch version
// repro_torch/kernels/ref.py::slstm_ref at the tolerances of csrc/slstm.cu.
//
// What bounds it: every step needs all of h_{t-1} before any channel of h_t
// can be formed, so the steps are serial and each one costs at least one
// exchange of h across the card. The arithmetic (2 * 4 * D^2 per row and
// step, 4.7 MFLOP at D = 768) and R itself (4.7 MB in bf16, read once) are
// far below what the card does in the time of that exchange. The design
// before this one (csrc/slstm.cu, one block per batch row) streamed all of
// R through one SM's load path every step: 105 us a step at D = 768.
//
// Design: a persistent grid of P = ceil(D / C) co-resident blocks, one per
// SM, launched cooperatively: cudaLaunchCooperativeKernel refuses
// (cudaErrorCooperativeLaunchTooLarge) a grid larger than the occupancy
// query's blocks per SM times the SMs, so a grid that could not all be
// resident is never started. Block j owns channels [j C, j C + C) and all
// four gates of each, and copies its slice of R once, at the start, into
// shared memory in R's stored dtype, as rows r_sh[(c * 4 + g) * RS + k] (k
// contiguous, zero past D; RS = D rounded up to 4, plus 4, so the copy's
// stores spread over the banks). R is thus read from device memory once per
// launch across the grid. One warp owns one channel: its lanes split k in
// chunks of 4 (one 16- or 8-byte shared load per gate), form the four dot
// products for up to 4 batch rows at a time against the resident slice, and
// sum the lanes' partials by a butterfly of shuffles, so every lane holds
// every row's sums. Lane b then applies the gates to batch row b, with c, n
// and m in its registers (B <= 32). Each step, every block stages the whole
// h_{t-1} for all B rows (B x D float32, served by L2) from a
// double-buffered global array into shared memory, writes its channels of
// h_t to the other half, and joins one grid-wide barrier: a 64-bit arrival
// counter, zero at the launch, that every block adds one to (after a fence)
// and polls with acquire loads until it reaches (step + 1) * P.
// The next step's wx is loaded before the barrier, so its latency hides in
// the wait. h crosses blocks only through L2: stores before the fence and
// arrival, loads (ld.global.cg) after the barrier.
//
// Summation order: each lane sums its D / 32 terms in order (chunks k = 4
// lane + 128 i), then the 32 partials are summed as a tree; no sequential
// sum runs over more than D / 32 terms (24 at D = 768).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;     // at most 16 channels (warps) a block
constexpr int kMaxChannels = kMaxThreads / 32;
constexpr int kMaxBatch = 32;        // one batch row per lane
constexpr int kCopyUnroll = 32;      // loads of R in flight per thread
constexpr long long kSpinLimit = 1LL << 33;   // cycles, several seconds

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a torch cast
}

// four consecutive elements of shared memory, upcast to float
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float log_sigmoid(float v) {
  return fminf(v, 0.0f) - log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Wait until every block of the grid has arrived `target / gridDim.x`
// times. Stores made before it by any thread of any block are visible to
// every thread after it: the block's stores reach thread 0 through the
// block barrier, its fence orders them before the arrival, and the acquire
// load that sees the last arrival orders the loads after it. Traps (a
// launch failure) instead of hanging if the count never comes in.
__device__ __forceinline__ void grid_sync(unsigned long long* arrivals,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    asm volatile("red.relaxed.gpu.global.add.u64 [%0], 1;"
                 :
                 : "l"(arrivals)
                 : "memory");
    const long long t0 = clock64();
    while (ld_acquire(arrivals) < target) {
      if (clock64() - t0 > kSpinLimit) __trap();
    }
  }
  __syncthreads();
}

template <int BT, typename TW, typename TR>
__global__ void __launch_bounds__(kMaxThreads)
slstm_grid_kernel(const TW* __restrict__ wx, const TR* __restrict__ r,
                  const TR* __restrict__ bg, const float* __restrict__ h0,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, TW* __restrict__ y,
                  float* __restrict__ h_out, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out,
                  float* hbuf, unsigned long long* bar, long long t_len,
                  int batch, int d, int ch, int dp, int rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  TR* r_sh = reinterpret_cast<TR*>(smem);                    // [ch * 4][rs]
  float* h_sh = reinterpret_cast<float*>(                    // [bp][dp]
      smem + static_cast<size_t>(ch) * 4 * rs * sizeof(TR));
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int e0 = blockIdx.x * ch;
  const int nc = min(ch, d - e0);            // channels of this block
  const int bp = (batch + BT - 1) / BT * BT;
  const long long four_d = 4LL * d;
  const long long bd = static_cast<long long>(batch) * d;

  // R[:, :, e0:e0+nc] -> r_sh. Thread (k0, j) copies column j = g nc + c
  // at k = k0, k0 + kstep, ...: a warp reads runs of nc contiguous
  // elements, kCopyUnroll loads in flight per thread
  const int ncols = 4 * nc;
  const int kstep = nth / ncols;             // >= 8: nth = 32 ch >= 8 ncols
  if (tid < kstep * ncols) {
    const int j = tid % ncols;
    const int g = j / nc;
    const int c = j - g * nc;
    const TR* src = r + g * d + e0 + c;
    TR* dst = r_sh + (c * 4 + g) * rs;
    for (int k0 = tid / ncols; k0 < d; k0 += kstep * kCopyUnroll) {
      TR v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int k = k0 + u * kstep;
        if (k < d) v[u] = src[k * four_d];
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int k = k0 + u * kstep;
        if (k < d) dst[k] = v[u];
      }
    }
  }
  const int pad = dp - d;
  for (int i = tid; i < ncols * pad; i += nth) {
    store(r_sh + (i / pad) * rs + d + i % pad, 0.0f);
  }
  for (int i = tid; i < bp * dp; i += nth) h_sh[i] = 0.0f;

  const int e = e0 + warp;
  const bool active = warp < nc;
  const bool owner = active && lane < batch;   // owns (row lane, channel e)
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float wxv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c = 0.0f, n = 0.0f, m = 0.0f, h = 0.0f;
  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = load_f32(bg + g * d + e);
  }
  const TW* wx_row = wx + static_cast<long long>(lane) * t_len * four_d + e;
  if (owner) {
    const long long s = static_cast<long long>(lane) * d + e;
    c = c0[s];
    n = n0[s];
    m = m0[s];
    h = h0[s];
#pragma unroll
    for (int g = 0; g < 4; ++g) wxv[g] = load_f32(wx_row + g * d);
  }
  __syncthreads();

  const int dq = dp / 4;
  // whole rows as 16-byte loads where they line up (then dp == d)
  const bool vec = (d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(h0) & 15) == 0;
  for (long long t = 0; t < t_len; ++t) {
    // h_{t-1} of every row into shared memory
    const float* hsrc = t == 0 ? h0 : hbuf + (t & 1) * bd;
    if (vec) {
      const float4* src4 = reinterpret_cast<const float4*>(hsrc);
      float4* dst4 = reinterpret_cast<float4*>(h_sh);
      for (int i = tid; i < bd / 4; i += nth) {
        dst4[i] = __ldcg(src4 + i);
      }
    } else {
      for (int i = tid; i < bd; i += nth) {
        const int b = i / d;
        h_sh[b * dp + (i - b * d)] = __ldcg(hsrc + i);
      }
    }
    __syncthreads();

    if (active) {
      const TR* rw = r_sh + warp * 4 * rs;
      float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int bt = 0; bt < batch; bt += BT) {
        float acc[BT][4];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[bb][g] = 0.0f;
        }
        for (int k4 = lane; k4 < dq; k4 += 32) {
          float rv[4][4];
#pragma unroll
          for (int g = 0; g < 4; ++g) load4(rw + g * rs + 4 * k4, rv[g]);
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            float hv[4];
            load4(h_sh + (bt + bb) * dp + 4 * k4, hv);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[bb][g] = fmaf(hv[q], rv[g][q], acc[bb][g]);
              }
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              acc[bb][g] += __shfl_xor_sync(0xffffffffu, acc[bb][g], off);
            }
          }
        }
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          if (lane == bt + bb) {
#pragma unroll
            for (int g = 0; g < 4; ++g) pre[g] = acc[bb][g];
          }
        }
      }
      if (owner) {
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = wxv[g] + pre[g] + bias[g];
        const float z = tanhf(pre[0]);
        const float i_t = pre[1];
        const float f_t = log_sigmoid(pre[2]);
        const float o = sigmoid(pre[3]);
        const float m_new = fmaxf(f_t + m, i_t);
        const float i_eff = expf(i_t - m_new);
        const float f_eff = expf(f_t + m - m_new);
        c = f_eff * c + i_eff * z;
        n = f_eff * n + i_eff;
        m = m_new;
        h = o * c / fmaxf(n, 1e-6f);
        __stcg(hbuf + ((t + 1) & 1) * bd + lane * d + e, h);
        store(y + (static_cast<long long>(lane) * t_len + t) * d + e, h);
      }
    }
    if (t + 1 < t_len) {
      if (owner) {
        const TW* wxt = wx_row + (t + 1) * four_d;
#pragma unroll
        for (int g = 0; g < 4; ++g) wxv[g] = load_f32(wxt + g * d);
      }
      grid_sync(bar, static_cast<unsigned long long>(t + 1) * gridDim.x);
    }
  }

  if (owner) {
    const long long s = static_cast<long long>(lane) * d + e;
    h_out[s] = h;
    c_out[s] = c;
    n_out[s] = n;
    m_out[s] = m;
  }
}

template <int BT, typename TW, typename TR>
int launch(const void* wx, const void* r, const void* bg, const float* h0,
           const float* c0, const float* n0, const float* m0, void* y,
           float* h_out, float* c_out, float* n_out, float* m_out,
           float* hbuf, unsigned long long* bar, long long t_len, int batch,
           int d, int ch, int dp, int rs, size_t smem, cudaStream_t s) {
  const int blocks = (d + ch - 1) / ch;
  const int threads = 32 * ch;
  auto kernel = slstm_grid_kernel<BT, TW, TR>;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const TW* wx_t = static_cast<const TW*>(wx);
  const TR* r_t = static_cast<const TR*>(r);
  const TR* bg_t = static_cast<const TR*>(bg);
  TW* y_t = static_cast<TW*>(y);
  void* args[] = {&wx_t,  &r_t,   &bg_t,  &h0,    &c0,    &n0, &m0,
                  &y_t,   &h_out, &c_out, &n_out, &m_out, &hbuf, &bar,
                  &t_len, &batch, &d,     &ch,    &dp,    &rs};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(threads), args, smem,
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW, typename TR>
int launch_bt(const void* wx, const void* r, const void* bg, const float* h0,
              const float* c0, const float* n0, const float* m0, void* y,
              float* h_out, float* c_out, float* n_out, float* m_out,
              float* hbuf, unsigned long long* bar, long long t_len,
              int batch, int d, int ch, int tile, int dp, int rs,
              size_t smem, cudaStream_t s) {
  if (tile == 1) {
    return launch<1, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                             n_out, m_out, hbuf, bar, t_len, batch, d, ch, dp,
                             rs, smem, s);
  }
  if (tile == 2) {
    return launch<2, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                             n_out, m_out, hbuf, bar, t_len, batch, d, ch, dp,
                             rs, smem, s);
  }
  return launch<4, TW, TR>(wx, r, bg, h0, c0, n0, m0, y, h_out, c_out,
                           n_out, m_out, hbuf, bar, t_len, batch, d, ch, dp,
                           rs, smem, s);
}

}  // namespace

// Launch on `stream`; returns a cudaError_t as an int (0 = launched).
// wx: contiguous [batch, t_len, 4, d], float (wx_bf16 = 0) or bfloat16
// (wx_bf16 = 1); y: [batch, t_len, d] of wx's type; r: [d, 4, d] and
// b: [4, d], float (r_bf16 = 0) or bfloat16 (r_bf16 = 1); h0, c0, n0, m0
// and the four outputs: float [batch, d]; hbuf: float scratch [2, batch,
// d]; bar: one 64-bit word, zero. The geometry is the caller's
// (repro_torch/kernels/slstm.py::grid_geometry): `channels` per block (so
// ceil(d / channels) blocks), 1 <= channels <= 16; batch rows formed
// `tile` (1, 2 or 4) at a time, 1 <= batch <= 32; row strides `dp` of h
// and `rs` of R in shared memory, multiples of 4 with d <= dp <= rs; and
// `smem` bytes of shared memory a block, at most the card's opt-in limit.
// cudaErrorInvalidValue if any is out of range;
// cudaErrorCooperativeLaunchTooLarge (720) if the grid cannot be
// co-resident.
extern "C" int slstm_sm90_launch(const void* wx, const void* r, const void* b,
                                 const void* h0, const void* c0,
                                 const void* n0, const void* m0, void* y,
                                 void* h_out, void* c_out, void* n_out,
                                 void* m_out, void* hbuf, void* bar,
                                 int batch, long long t_len, int d,
                                 int wx_bf16, int r_bf16, int channels,
                                 int tile, int dp, int rs, long long smem,
                                 void* stream) {
  if (batch < 1 || batch > kMaxBatch || t_len < 1 || d < 1 ||
      channels < 1 || channels > kMaxChannels ||
      (tile != 1 && tile != 2 && tile != 4) || dp < d || dp % 4 != 0 ||
      rs < dp || rs % 4 != 0 || smem < 1) {
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
  float* hb = static_cast<float*>(hbuf);
  unsigned long long* br = static_cast<unsigned long long*>(bar);
  const size_t sm = static_cast<size_t>(smem);
  if (wx_bf16 && r_bf16) {
    return launch_bt<__nv_bfloat16, __nv_bfloat16>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, hb, br, t_len, batch, d,
        channels, tile, dp, rs, sm, s);
  }
  if (wx_bf16) {
    return launch_bt<__nv_bfloat16, float>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, hb, br, t_len, batch, d,
        channels, tile, dp, rs, sm, s);
  }
  if (r_bf16) {
    return launch_bt<float, __nv_bfloat16>(
        wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, hb, br, t_len, batch, d,
        channels, tile, dp, rs, sm, s);
  }
  return launch_bt<float, float>(
      wx, r, b, hi, ci, ni, mi, y, ho, co, no, mo, hb, br, t_len, batch, d,
      channels, tile, dp, rs, sm, s);
}
