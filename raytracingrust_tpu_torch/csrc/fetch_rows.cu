// Winner-row fetch (#6) and its transpose (#7), written for Hopper (sm_90a).
//
// Replace raytracingrust_tpu/ops/pallas_megakernel.py's fetch kernel pair,
// _make_fetch_kernel(bwd=False) and (bwd=True) under _fetch_rows_cvjp: the
// rows of each recorded BVH winner for the differentiable replay
// (diff/replay.py), and the scatter of the replay's row cotangents back onto
// the tables.  The TPU kernels built one-hot matrices over 1,024-slot
// superchunks and multiplied them on the MXU; here a gather is a gather and
// a scatter-add is an atomic add.
//
// Layouts (ops/fetch.py): codes (n,) int32, n = max_depth * n_rays, the
// record mode's winner slot in bits 0-26 (sphere slots below tri_base,
// triangle slots from it), -1 on a miss; sphere rows (S, 4) [center,
// radius], triangle rows (T, 12) [v0, e1, e2, flat normal], each slot's
// material id; the material table (M, 8) [albedo rgb, fuzz, ir, emission
// rgb] with (M,) kinds.  Fetched rows are field-major, (G + 8, n) float32:
// G = 4 or 12 geometry fields, then the 8 material fields; a miss gives
// zeros and kind -1.
//
// #6: one thread per code, the rows read as float4 through the read-only
// path, each field stored coalesced.  Bound by bytes: 4 in and 4 (G + 9)
// out per code; the tables (a few hundred KB) stay in L2.
//
// #7: the same thread mapping over a grid-stride loop of a few blocks per
// SM, float32 atomics.  Two hot spots are designed out: a warp's lanes that
// won the same slot (a ground sphere under most rays) add their
// cotangents first (__match_any_sync, then a shuffle tree among the peers)
// and issue one atomic per field; and material cotangents, where a scene
// may have 4 materials under 8M rays, go to a per-block table in shared
// memory (after the same aggregation by material id), which each block
// adds to the global table once at its end.  The sums' order depends on
// scheduling, so #7 agrees with its plain version to rounding, not bit for
// bit.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlot = (1 << 27) - 1;
constexpr int kMat = 8;
constexpr int kBlocksPerSm = 4;
// the largest material table #7 sums in shared memory (48 KB, the most a
// block takes without opting in)
constexpr int kMaxSharedMats = 48 * 1024 / (kMat * 4);

struct Tables {
  const float* sph_geo;  // (S, 4), or null in #7 and without spheres
  const int* sph_mat;    // (S,)
  const float* tri_geo;  // (T, 12), or null in #7 and without triangles
  const int* tri_mat;    // (T,)
  int tri_base;          // codes from here on are triangle slots
};

__global__ void __launch_bounds__(kThreads)
fetch_kernel(const int* __restrict__ codes, long long n, Tables t,
             const float* __restrict__ mats, const int* __restrict__ kinds,
             int geo_w, float* __restrict__ rows, int* __restrict__ kind) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int code = __ldg(codes + i);
  float v[12 + kMat];
#pragma unroll
  for (int k = 0; k < 12 + kMat; ++k) v[k] = 0.0f;
  int kd = -1;
  if (code >= 0) {
    const int slot = code & kSlot;
    int mid;
    if (slot < t.tri_base) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(t.sph_geo) +
                             slot);
      v[0] = g.x;
      v[1] = g.y;
      v[2] = g.z;
      v[3] = g.w;
      mid = __ldg(t.sph_mat + slot);
    } else {
      const int s = slot - t.tri_base;
      const float4* g = reinterpret_cast<const float4*>(t.tri_geo) + 3 * s;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 r = __ldg(g + q);
        v[4 * q + 0] = r.x;
        v[4 * q + 1] = r.y;
        v[4 * q + 2] = r.z;
        v[4 * q + 3] = r.w;
      }
      mid = __ldg(t.tri_mat + s);
    }
    const float4* m = reinterpret_cast<const float4*>(mats) + 2 * mid;
    const float4 m0 = __ldg(m), m1 = __ldg(m + 1);
    v[12] = m0.x;
    v[13] = m0.y;
    v[14] = m0.z;
    v[15] = m0.w;
    v[16] = m1.x;
    v[17] = m1.y;
    v[18] = m1.z;
    v[19] = m1.w;
    kd = __ldg(kinds + mid);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k)
    if (k < geo_w) rows[k * n + i] = v[k];
#pragma unroll
  for (int k = 0; k < kMat; ++k) rows[(geo_w + k) * n + i] = v[12 + k];
  kind[i] = kd;
}

// Sums v over the lanes of `peers` (the lanes of the warp that hold the
// same key): afterwards the lowest lane of the group holds the group's
// sum.  Every lane of the warp calls it together.  Each round a lane adds
// the partial sum of the next peer still in play, and the lanes whose rank
// has a set lowest bit leave the play: log2 of the group's size rounds.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, or 0
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float o = __shfl_sync(0xffffffffu, v[k], src);
      if (next) v[k] += o;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
}

template <bool kSharedMats>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const int* __restrict__ codes, long long n, Tables t,
                 const float* __restrict__ g, int geo_w, int n_mats,
                 float* __restrict__ d_sph, float* __restrict__ d_tri,
                 float* __restrict__ d_mats) {
  extern __shared__ float s_mats[];  // n_mats * kMat when kSharedMats
  if (kSharedMats) {
    for (int j = threadIdx.x; j < n_mats * kMat; j += blockDim.x)
      s_mats[j] = 0.0f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the whole warp takes each step together (the shuffles need every lane)
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const int code = i < n ? __ldg(codes + i) : -1;
    if (__all_sync(0xffffffffu, code < 0)) continue;  // a warp of misses
    const int c = code & kSlot;
    const bool tri = code >= 0 && c >= t.tri_base;
    const int slot = tri ? c - t.tri_base : c;
    float v[12];
    float m[kMat];
    int mid = -1;
#pragma unroll
    for (int k = 0; k < 12; ++k) v[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMat; ++k) m[k] = 0.0f;
    if (code >= 0) {
      mid = __ldg((tri ? t.tri_mat : t.sph_mat) + slot);
      const int w = tri ? 12 : 4;
#pragma unroll
      for (int k = 0; k < 12; ++k)
        if (k < w) v[k] = __ldg(g + k * n + i);
#pragma unroll
      for (int k = 0; k < kMat; ++k) m[k] = __ldg(g + (geo_w + k) * n + i);
    }

    // geometry: the lanes that won one slot, one atomic per field
    const int key = code >= 0 ? c : -1;
    unsigned peers = __match_any_sync(0xffffffffu, key);
    reduce_peers(peers, v);
    if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
      float* dst = tri ? d_tri + 12 * (size_t)slot : d_sph + 4 * (size_t)slot;
      const int w = tri ? 12 : 4;
      for (int k = 0; k < w; ++k) atomicAdd(dst + k, v[k]);
    }

    // materials: the lanes of one material id, into the block's table
    peers = __match_any_sync(0xffffffffu, mid);
    reduce_peers(peers, m);
    if (mid >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
      float* dst = kSharedMats ? s_mats + kMat * mid : d_mats + kMat * mid;
#pragma unroll
      for (int k = 0; k < kMat; ++k) atomicAdd(dst + k, m[k]);
    }
  }
  if (kSharedMats) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_mats * kMat; j += blockDim.x)
      if (s_mats[j] != 0.0f) atomicAdd(d_mats + j, s_mats[j]);
  }
}

}  // namespace

// Plain C entries, bound with ctypes (ops/fetch.py).  Each launches on
// `stream` and returns cudaGetLastError() of its launch.

extern "C" int rtrt_fetch_rows(const int* codes, long long n,
                               const float* sph_geo, const int* sph_mat,
                               const float* tri_geo, const int* tri_mat,
                               int tri_base, const float* mats,
                               const int* kinds, int geo_w, float* rows,
                               int* kind, void* stream) {
  if (n <= 0 || (geo_w != 4 && geo_w != 12) || tri_base < 0)
    return (int)cudaErrorInvalidValue;
  const Tables t{sph_geo, sph_mat, tri_geo, tri_mat, tri_base};
  const long long blocks = (n + kThreads - 1) / kThreads;
  fetch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      codes, n, t, mats, kinds, geo_w, rows, kind);
  return (int)cudaGetLastError();
}

extern "C" int rtrt_fetch_rows_transpose(const int* codes, long long n,
                                         const int* sph_mat,
                                         const int* tri_mat, int tri_base,
                                         const float* g, int geo_w,
                                         int n_mats, float* d_sph,
                                         float* d_tri, float* d_mats,
                                         void* stream) {
  if (n <= 0 || (geo_w != 4 && geo_w != 12) || tri_base < 0 || n_mats < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Tables t{nullptr, sph_mat, nullptr, tri_mat, tri_base};
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  if (n_mats <= kMaxSharedMats)
    transpose_kernel<true><<<blocks, kThreads, n_mats * kMat * sizeof(float),
                             (cudaStream_t)stream>>>(
        codes, n, t, g, geo_w, n_mats, d_sph, d_tri, d_mats);
  else
    transpose_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        codes, n, t, g, geo_w, n_mats, d_sph, d_tri, d_mats);
  return (int)cudaGetLastError();
}
