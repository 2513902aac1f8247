// Flash attention forward (GQA/MQA, causal or full) over
//
//   q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D], all float32 or all bfloat16,
//
// returning o [B, Tq, Hq, D] in q's dtype and lse [B, Hq, Tq] in float32:
//
//   s   = (q * scale) k^T                           (float32, no TF32)
//   s   = -1e30 where masked: causal keys past q_pos + (Tk - Tq)
//   o   = softmax(s) v,  lse = m + log(l)           (online: m, l, acc f32)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pallas_call at line 111, reached through flash_attention
// and kernels.ops.attention). Held against the plain PyTorch version
// repro_torch/kernels/ref.py::mha_ref, o and lse: the reference test's
// 2e-6 in float32 and 2e-2 in bfloat16 on its shapes.
//
// What bounds it: operations. At gemma-2b's train shape (1, 2048, 2048, 8
// query heads over 1 kv head, D = 256) the causal half of the two products
// is about 17.2 GFLOP against 38 MB moved in float32: 0.26 ms of float32
// FMA work at 67 TFLOP/s against 0.011 ms of bytes at 3.35 TB/s.
//
// Design: the Pallas kernel walks a (B, Hq, q-blocks, k-blocks) grid whose
// last axis is sequential, carrying m, l and acc in VMEM scratch. Here one
// thread block of 256 threads owns one (b, q head, 64-row q tile) and walks
// the k tiles itself, so nothing is carried between blocks. The q tile
// (pre-scaled, float32) and one 64-row k and v tile sit in shared memory
// (about 211 KB at D = 256, over the 48 KB default: the launcher opts in).
// Thread (ty, tx) of a 16 x 16 layout owns rows 4ty..4ty+3 of the tile: it
// computes their scores against keys tx, tx+16, tx+32, tx+48 with float4
// reads of q and k (k rows padded by 4 floats, so a quarter warp hits 32
// distinct banks), reduces row max and row sum across the 16 threads of its
// half warp with shuffles, and keeps acc for its 4 rows x D/16 columns in
// registers. D is padded with zeros to 64, 128 or 256 in shared memory.
//
// Order: blockIdx.x is the q head and blockIdx.y counts q tiles from the
// last, so the blocks that walk the most k tiles under the causal mask are
// dispatched first and the short ones fill in behind them.
//
// Masking: keys at or past Tk are never counted (p = 0); causal-masked
// keys get s = -1e30 as in the reference, so a row that sees no key at all
// (Tq > Tk) averages v over all Tk keys as mha_ref does. Under the causal
// mask, k tiles wholly past a q tile's last visible key are skipped unless
// the tile holds such a fully masked row; this changes no result, since
// p = exp(-1e30 - m) = 0 once a row has seen a key.
//
// bf16 calls that TMA can address run on csrc/flash_attention_sm90.cu
// instead (wgmma / TMA; `repro_torch.kernels.flash_attention.route`); this
// kernel takes float32 and every other bf16 call. There is no backward
// kernel: the backward is the ported blockwise recomputation in plain
// PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PS = BK + 4;      // row stride of the p tile (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a torch cast
}

template <int DP>
constexpr int smem_bytes() {
  // sQ and sK rows padded by 4 floats; sV unpadded; sP
  return (BQ * (DP + 4) + BK * (DP + 4) + BK * DP + BQ * PS) * 4;
}

template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int tq, int tk, int hq,
                       int hkv, int d, float scale, int causal) {
  constexpr int QS = DP + 4;    // row stride of sQ and sK (floats)
  constexpr int CG = DP / 64;   // float4 column groups of acc per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);           // kv head of this q head
  const long long q_stride = (long long)hq * d;    // between tokens
  const long long kv_stride = (long long)hkv * d;
  const T* qb = q + (long long)b * tq * q_stride + (long long)h * d;
  const T* kb = k + (long long)b * tk * kv_stride + (long long)hk * d;
  const T* vb = v + (long long)b * tk * kv_stride + (long long)hk * d;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    const int t = q0 + r;
    float x = 0.0f;
    if (t < tq && c < d) x = load_f32(qb + t * q_stride + c) * scale;
    sQ[r * QS + c] = x;
  }

  // causal: row r sees keys <= r + shift (the q block is aligned to the
  // END of the kv span)
  const int shift = tk - tq;
  int k_end = tk;
  if (causal && q0 + shift >= 0) {
    const int last_row = min(q0 + BQ, tq) - 1;
    k_end = min(tk, last_row + shift + 1);
  }

  float m[4], l[4], acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's sK, sV and sP reads are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      const int t = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (t < tk && c < d) {
        kx = load_f32(kb + t * kv_stride + c);
        vx = load_f32(vb + t * kv_stride + c);
      }
      sK[r * QS + c] = kx;
      sV[r * DP + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * QS + dd);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ka[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * QS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qa[i].x, ka[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, ka[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, ka[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, ka[c].w, s[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        if (col >= tk || (causal && col > row + shift)) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        const float p = col < tk ? expf(s[i][c] - m_new) : 0.0f;
        rs += p;
        sP[(4 * ty + i) * PS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * CG; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sV + (kk + u) * DP + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                          : u == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

  T* ob = o + (long long)b * tq * q_stride + (long long)h * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= tq) continue;
    const float safe_l = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < d) store(ob + row * q_stride + col, acc[i][4 * g + e] / safe_l);
      }
    if (tx == 0)
      lse[((long long)b * hq + h) * tq + row] = m[i] + logf(safe_l);
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int tq, int tk, int hq, int hkv, int d, float scale,
           int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();
  auto kernel = flash_attention_kernel<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, (tq + BQ - 1) / BQ, b);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, hq, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int tq, int tk, int hq, int hkv, int d, float scale,
             int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<64, T>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale,
                         causal, stream);
  if (d <= 128)
    return launch<128, T>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale,
                          causal, stream);
  return launch<256, T>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale,
                        causal, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). Returns the CUDA
// error of the attribute call or the launch (0 on success); the wrapper
// checks shapes (1 <= d <= 256, hq % hkv == 0, at most 65535 q tiles and
// batch rows) before calling.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int tq, int tk, int hq, int hkv,
                                      int d, float scale, int causal,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale,
                           causal, s);
  return launch_d<__nv_bfloat16>(q, k, v, o, lse, b, tq, tk, hq, hkv, d,
                                 scale, causal, s);
}
