// Winner-row fetch (#6) and its transpose (#7), written for Hopper (sm_90a).
//
// Replace raytracingrust_tpu/ops/pallas_megakernel.py's fetch kernel pair,
// _make_fetch_kernel(bwd=False) and (bwd=True) under _fetch_rows_cvjp: the
// rows of each recorded BVH winner for the differentiable replay
// (diff/replay.py), and the scatter of the replay's row cotangents back onto
// the tables.  The TPU kernels built one-hot matrices over 1,024-slot
// superchunks and multiplied them on the MXU, the transpose's sums in grid
// order, the same bits each run; here a gather is a gather, and the
// scatter-add sums in an order fixed by its inputs alone, with no atomic.
//
// Layouts (ops/fetch.py): codes (n,) int32, n = max_depth * n_rays, the
// record mode's winner slot in bits 0-26 (sphere slots below tri_base,
// triangle slots from it), -1 on a miss; sphere rows (S, 4) [center,
// radius], triangle rows (T, 12) [v0, e1, e2, flat normal], each slot's
// material id; the material table (M, 8) [albedo rgb, fuzz, ir, emission
// rgb] with (M,) kinds.  Fetched rows are field-major, (G + 8, n) float32:
// G = 4 or 12 geometry fields, then the 8 material fields; a miss gives
// zeros and kind -1.  A mesh volume's code (mv_base + v) gives zero
// geometry and the material row of the volume's phase material, from the
// (V,) table of the volumes' material ids (the JAX record reads it from a
// per-volume table too, _pack_fparams); #7 adds its material cotangents to
// that material's row and its geometry's nowhere: the boundary's vertices
// get no gradient, as in the JAX replay.
//
// The sphere-like table is the solid spheres' slots and then the volume
// spheres' (ops/bvh_kernel.fetch_inputs), as the codes number them.  Raw
// mode (a scene with mixes, whose winner's material depends on the
// bounce's coins): #6 writes the G geometry fields only and the winner's
// raw material id in place of its kind, and #7 scatters the geometry only;
// the replay resolves the mix and indexes the material table itself.
//
// #6: one thread per code, the rows read as float4 through the read-only
// path, each field stored coalesced.  Bound by bytes: 4 in and 4 (G + 9)
// out per code (4 (G + 1) in raw mode); the tables (a few hundred KB) stay
// in L2.
//
// #7 sums into one flat table of n_floats: the sphere rows (4 S floats),
// the triangle rows (12 T) and, unless raw, the material rows (8 M); every
// row starts on a float4.  Most codes of a deep bounce miss, and the hits
// pile onto a few rows (a ground sphere under most rays, 4 materials under
// 8M rays), so float atomics on the table serialise in L2, and their order
// changes from run to run.  Instead, three launches, each grouping its sums
// by the inputs alone (the wrapper's plan, ops/fetch.transpose_plan, a
// function of the table's size, never of the card):
// - transpose_compact_kernel: `segments` blocks each compact the hits of a
//   fixed share of the codes, in code order, at full occupancy;
// - transpose_kernel: the hits, in segment order, cut into equal runs, one
//   a warp, so a warp takes the same share wherever the hits lie.  A warp
//   walks its run kBatch hits a lane at a time (their loads in flight
//   together); the lanes that won one row add their cotangents first
//   (__match_any_sync, then reduce_peers, an order fixed by the lanes'
//   contents), and the group's lowest lane adds the sum into the warp's
//   own copy of the table with a plain float4 load-add-store.  The copies
//   sit in shared memory where 4 to 8 of them fit a block (the small path;
//   the block then adds them in warp order into its row of `partials`),
//   else in global memory, one row of `partials` each (the large path: a
//   sheet's 8,192 triangles, thousands of materials);
// - transpose_reduce_kernel: each table entry sums its column of
//   `partials` in row order.
// Bound by bytes: the codes, the hits' cotangents and the tables once; the
// hits' cotangents are a gather (a 32-byte sector a field of a lone hit).
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
// #7: the hits a lane takes before it adds any, their loads in flight
// together; the codes a thread of the compaction loads at once
constexpr int kBatch = 4;
constexpr int kCompact = 8;
// #7's compaction: its threads a block
constexpr int kCompactThreads = 512;

struct Tables {
  const float* sph_geo;  // (S, 4), or null in #7 and without spheres
  const int* sph_mat;    // (S,)
  const float* tri_geo;  // (T, 12), or null in #7 and without triangles
  const int* tri_mat;    // (T,)
  int tri_base;          // codes from here on are triangle slots
  const int* mv_mat;     // (V,) the mesh volumes' material ids, or null
  int mv_base;           // codes from here on are mesh volumes
};

__global__ void __launch_bounds__(kThreads)
fetch_kernel(const int* __restrict__ codes, long long n, Tables t,
             const float* __restrict__ mats, const int* __restrict__ kinds,
             int geo_w, int raw, float* __restrict__ rows,
             int* __restrict__ kind) {
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
    if (t.mv_mat && slot >= t.mv_base) {  // a mesh volume: no geometry
      mid = __ldg(t.mv_mat + (slot - t.mv_base));
    } else if (slot < t.tri_base) {
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
    if (raw) {
      kd = mid;
    } else {
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
  }
#pragma unroll
  for (int k = 0; k < 12; ++k)
    if (k < geo_w) rows[k * n + i] = v[k];
  if (!raw) {
#pragma unroll
    for (int k = 0; k < kMat; ++k) rows[(geo_w + k) * n + i] = v[12 + k];
  }
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

// Where a code's cotangents go in the flat table (see the comment at the
// top): the offset of its geometry row and of its material row, -1 where
// it has none; and the geometry row's width.
struct Dest {
  int geo, mat, w;
};

template <bool kRaw>
__device__ __forceinline__ Dest dest_of(int code, const Tables& t,
                                        int mat_base) {
  Dest d{-1, -1, 0};
  if (code < 0) return d;
  const int c = code & kSlot;
  const bool fog = t.mv_mat && c >= t.mv_base;
  const bool tri = !fog && c >= t.tri_base;
  const int slot = fog ? c - t.mv_base : tri ? c - t.tri_base : c;
  if (!fog) {
    d.w = tri ? 12 : 4;
    d.geo = tri ? 4 * t.tri_base + 12 * slot : 4 * slot;
  }
  if (!kRaw)
    d.mat = mat_base + kMat * __ldg((fog ? t.mv_mat
                                         : tri ? t.tri_mat : t.sph_mat) +
                                    slot);
  return d;
}

// The lanes of the warp that won one row `at` (their groups found by
// __match_any_sync) sum their v[0..w) (reduce_peers), and each group's
// lowest lane adds the sum into the warp's own copy of the table, `row`,
// in shared or global memory.  No two groups share a row, and no other
// warp writes the copy, so a plain load-add-store is race free; the warp's
// barrier after it orders it before the next call's.  Every lane of the
// warp calls it together; a lane with no row (at -1) sits the sum out.
template <int N>
__device__ __forceinline__ void add_row(float* row, int at, int w,
                                        float (&v)[N]) {
  if (!__any_sync(0xffffffffu, at >= 0)) return;
  const int lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(0xffffffffu, at);
  if (at < 0) peers = 1u << lane;
  reduce_peers(peers, v);
  if (at >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
    float4* r = reinterpret_cast<float4*>(row + at);
    float4 o[N / 4];  // every load before any store
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      if (4 * q < w) o[q] = r[q];
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      if (4 * q < w) {
        o[q].x += v[4 * q];
        o[q].y += v[4 * q + 1];
        o[q].z += v[4 * q + 2];
        o[q].w += v[4 * q + 3];
        r[q] = o[q];
      }
  }
  __syncwarp();
}

// #7's first pass: the hits of segment blockIdx.x of the codes (a fixed
// 1/gridDim.x of them), compacted in code order into hits[c0 ..) as
// (index, code) pairs, c0 the segment's first code; their count into
// counts[blockIdx.x].  No table, so every warp an SM can be reading codes.
// A step of the block takes kCompactThreads * kCompact codes, each warp
// 32 * kCompact consecutive ones; one prefix over the warps a step.
__global__ void __launch_bounds__(kCompactThreads)
transpose_compact_kernel(const int* __restrict__ codes, long long n,
                         int2* __restrict__ hits, int* __restrict__ counts) {
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ int s_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long c0 = n * blockIdx.x / gridDim.x;
  const long long c1 = n * (blockIdx.x + 1) / gridDim.x;
  int run = 0;  // the segment's hits before this step
  for (long long base = c0; base < c1; base += kCompactThreads * kCompact) {
    const long long w0 = base + (long long)warp * 32 * kCompact;
    int code[kCompact];
    unsigned mask[kCompact];
#pragma unroll
    for (int u = 0; u < kCompact; ++u) {
      const long long i = w0 + 32 * u + lane;
      code[u] = i < c1 ? __ldg(codes + i) : -1;
    }
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kCompact; ++u) {
      mask[u] = __ballot_sync(0xffffffffu, code[u] >= 0);
      mine += __popc(mask[u]);
    }
    if (lane == 0) s_cnt[warp] = mine;
    __syncthreads();
    int at = run;  // in code order: warp, then u, then lane
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w];
      if (w < warp) at += c;
      run += c;
    }
#pragma unroll
    for (int u = 0; u < kCompact; ++u) {
      if (code[u] >= 0)
        hits[c0 + at + __popc(mask[u] & below)] =
            make_int2((int)(w0 + 32 * u + lane), code[u]);
      at += __popc(mask[u]);
    }
    __syncthreads();  // s_cnt is read before the next step writes it
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = run;
}

// The hits, in segment order, in equal runs, one for each warp of the
// grid: each warp sums its run into its own copy of the table.  kShared:
// the block's warps hold their copies in shared memory and at the end add
// them in warp order into row blockIdx.x of `partials`; else each warp's
// copy is its own row of `partials`, blockIdx.x * warps + warp.  Dynamic
// shared memory (transpose_smem): the hits before each segment and each
// segment's first code, then, from the next float4, the copies where
// kShared (with the copies first, ptxas spilled the <4, true, true>
// instance and it ran 7% slower).
template <int kGeo, bool kRaw, bool kShared>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const int2* __restrict__ hits,
                 const int* __restrict__ counts, int segments, long long n,
                 Tables t, const float* __restrict__ g, int mat_base,
                 int n_floats, float* __restrict__ partials) {
  extern __shared__ float4 s_dyn[];
  int* s_pre = reinterpret_cast<int*>(s_dyn);  // (segments + 1,)
  int* s_first = s_pre + segments + 1;         // (segments,)
  float4* s_tab = s_dyn + (2 * segments + 4) / 4;  // (warps, n_floats)
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {  // the prefix of the segments' counts
    int run = 0;
    for (int b = 0; b < segments; b += 32) {
      const int v = b + lane < segments ? __ldg(counts + b + lane) : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b + lane < segments) s_pre[b + lane] = run + x - v;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) s_pre[segments] = run;
  }
  for (int k = threadIdx.x; k < segments; k += blockDim.x)
    s_first[k] = (int)(n * k / segments);
  const long long copy = (long long)blockIdx.x * warps + warp;
  float* row = kShared ? reinterpret_cast<float*>(s_tab) + warp * n_floats
                       : partials + copy * n_floats;
  if (kShared) {
    for (int j = threadIdx.x; j < warps * n_floats / 4; j += blockDim.x)
      s_tab[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int j = lane; j < n_floats / 4; j += 32)
      reinterpret_cast<float4*>(row)[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const long long all = s_pre[segments];
  const long long copies = (long long)gridDim.x * warps;
  const int p0 = (int)(all * copy / copies);
  const int p1 = (int)(all * (copy + 1) / copies);
  constexpr int kM = kRaw ? 1 : kMat;
  for (int base = p0; base < p1; base += 32 * kBatch) {
    Dest d[kBatch];
    int idx[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = base + 32 * u + lane;
      int code = -1;
      idx[u] = 0;
      if (p < p1) {  // its segment: the last whose first hit is at most p
        int a = 0, z = segments;
        while (z - a > 1) {
          const int mid = (a + z) >> 1;
          if (s_pre[mid] <= p)
            a = mid;
          else
            z = mid;
        }
        const int2 h = __ldg(hits + s_first[a] + (p - s_pre[a]));
        idx[u] = h.x;
        code = h.y;
      }
      d[u] = dest_of<kRaw>(code, t, mat_base);
    }
    float v[kBatch][kGeo];
    float m[kBatch][kM];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = idx[u];  // the hit's code
#pragma unroll
      for (int k = 0; k < kGeo; ++k)
        v[u][k] = d[u].geo >= 0 && k < d[u].w ? __ldg(g + k * n + i) : 0.0f;
#pragma unroll
      for (int k = 0; k < kM; ++k)
        m[u][k] = !kRaw && d[u].mat >= 0 ? __ldg(g + (kGeo + k) * n + i)
                                         : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // the lanes that won one row add their sums first: one add a row
      add_row(row, d[u].geo, d[u].w, v[u]);
      if constexpr (!kRaw) add_row(row, d[u].mat, kMat, m[u]);
    }
  }
  if (kShared) {
    __syncthreads();
    const float* tab = reinterpret_cast<const float*>(s_tab);
    float* dst = partials + (size_t)blockIdx.x * n_floats;
    for (int j = threadIdx.x; j < n_floats; j += blockDim.x) {
      float s = tab[j];
      for (int w = 1; w < warps; ++w) s += tab[w * n_floats + j];
      dst[j] = s;
    }
  }
}

// The last pass: each entry j of the flat table is the sum of column j of
// `partials` over its rows in row order, in kRowGroups runs of consecutive
// rows (one warp each, 32 entries a block) then added in run order; entry
// j goes to d_sph below geo_tri, to d_tri below mat_base, else to d_mats.
constexpr int kRowGroups = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
transpose_reduce_kernel(const float* __restrict__ partials, int rows,
                        int n_floats, int geo_tri, int mat_base,
                        float* __restrict__ d_sph, float* __restrict__ d_tri,
                        float* __restrict__ d_mats) {
  __shared__ float s_run[kRowGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int r0 = rows * grp / kRowGroups;
  const int r1 = rows * (grp + 1) / kRowGroups;
  float s = 0.0f;
  if (j < n_floats)
#pragma unroll 8
    for (int r = r0; r < r1; ++r)
      s += __ldg(partials + (size_t)r * n_floats + j);
  s_run[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || j >= n_floats) return;
  for (int q = 1; q < kRowGroups; ++q) s += s_run[q][lane];
  if (j < geo_tri)
    d_sph[j] = s;
  else if (j < mat_base)
    d_tri[j - geo_tri] = s;
  else
    d_mats[j - mat_base] = s;
}

// The dynamic shared memory of a transpose_kernel block (the wrapper's
// plan, ops/fetch.transpose_plan, takes the small path where it is within
// the card's opt-in maximum).
long long transpose_smem(int warps, long long n_floats, int segments,
                         int shared) {
  return (shared ? warps * n_floats * (long long)sizeof(float) : 0LL) +
         (2LL * segments + 4) / 4 * (long long)sizeof(float4);
}

template <int kGeo, bool kRaw>
cudaError_t launch_transpose(const int2* hits, const int* counts,
                             int segments, long long n, const Tables& t,
                             const float* g, int mat_base, int n_floats,
                             int warps, int blocks, int shared,
                             float* partials, cudaStream_t stream) {
  auto kernel = shared ? transpose_kernel<kGeo, kRaw, true>
                      : transpose_kernel<kGeo, kRaw, false>;
  const int smem = (int)transpose_smem(warps, n_floats, segments, shared);
  if (smem > 48 * 1024) {  // past the default, the block opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;  // past the card's maximum
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(
      hits, counts, segments, n, t, g, mat_base, n_floats, partials);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes (ops/fetch.py).  Each launches on
// `stream` and returns cudaGetLastError() of its launch.

// The mesh volumes: their first code `mv_base` and the n_mv material ids
// `mv_mat` (null and 0 without them).

extern "C" int rtrt_fetch_rows(const int* codes, long long n,
                               const float* sph_geo, const int* sph_mat,
                               const float* tri_geo, const int* tri_mat,
                               int tri_base, const float* mats,
                               const int* kinds, int geo_w, int raw,
                               float* rows, int* kind, int mv_base,
                               const int* mv_mat, int n_mv, void* stream) {
  if (n <= 0 || (geo_w != 4 && geo_w != 12) || tri_base < 0 || n_mv < 0 ||
      (n_mv > 0) != (mv_mat != nullptr) || (n_mv > 0 && mv_base < tri_base))
    return (int)cudaErrorInvalidValue;
  const Tables t{sph_geo, sph_mat, tri_geo, tri_mat, tri_base, mv_mat,
                 mv_base};
  const long long blocks = (n + kThreads - 1) / kThreads;
  fetch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      codes, n, t, mats, kinds, geo_w, raw, rows, kind);
  return (int)cudaGetLastError();
}

// #7 with the wrapper's plan: the codes compacted in `segments` segments
// into `hits` (n (index, code) pairs, int2-aligned) with their `counts`
// (segments,); then `blocks` blocks of `warps` warps, each warp's copy of
// the table in shared memory (`shared`: `partials` (blocks, n_floats)) or
// in global memory (`partials` (blocks * warps, n_floats), float4-aligned);
// all three scratch, every entry that is read written first.  d_sph
// (tri_base, 4), d_tri (n_tri, 12) and d_mats (n_mats, 8) are written whole
// (null where the table is absent, d_mats in raw mode).
extern "C" int rtrt_fetch_rows_transpose(
    const int* codes, long long n, const int* sph_mat, const int* tri_mat,
    int tri_base, int n_tri, const float* g, int geo_w, int raw, int n_mats,
    int mv_base, const int* mv_mat, int n_mv, int segments, int warps,
    int blocks, int shared, int* hits, int* counts, float* partials,
    float* d_sph, float* d_tri, float* d_mats, void* stream) {
  const long long mat_base = 4LL * tri_base + 12LL * n_tri;
  const long long n_floats = mat_base + (raw ? 0LL : 8LL * n_mats);
  const long long rows = shared ? blocks : (long long)blocks * warps;
  if (n <= 0 || n >= (1LL << 31) || (geo_w != 4 && geo_w != 12) ||
      tri_base < 0 || n_tri < 0 || n_mats < 1 || (!raw && !d_mats) ||
      (tri_base > 0 && !(sph_mat && d_sph)) ||
      (n_tri > 0 && !(tri_mat && d_tri)) || (geo_w == 4 && n_tri > 0) ||
      n_mv < 0 || (n_mv > 0) != (mv_mat != nullptr) ||
      (n_mv > 0 && mv_base != tri_base + n_tri) || n_floats < 4 ||
      n_floats >= (1LL << 31) || segments < 1 || warps < 1 ||
      warps * 32 > kThreads || blocks < 1 || rows * n_floats >= (1LL << 40) ||
      transpose_smem(warps, n_floats, segments, shared) >= (1LL << 31) ||
      !hits || !counts || !partials ||
      reinterpret_cast<uintptr_t>(hits) % sizeof(int2) ||
      reinterpret_cast<uintptr_t>(partials) % sizeof(float4))
    return (int)cudaErrorInvalidValue;
  const Tables t{nullptr, sph_mat, nullptr, tri_mat, tri_base, mv_mat,
                 mv_base};
  const cudaStream_t s = (cudaStream_t)stream;
  int2* pairs = reinterpret_cast<int2*>(hits);
  transpose_compact_kernel<<<segments, kCompactThreads, 0, s>>>(
      codes, n, pairs, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nf = (int)n_floats, mb = (int)mat_base;
  auto launch = geo_w == 4 ? (raw ? launch_transpose<4, true>
                                  : launch_transpose<4, false>)
                           : (raw ? launch_transpose<12, true>
                                  : launch_transpose<12, false>);
  err = launch(pairs, counts, segments, n, t, g, mb, nf, warps, blocks,
               shared, partials, s);
  if (err != cudaSuccess) return (int)err;
  transpose_reduce_kernel<<<(nf + 31) / 32, kThreads, 0, s>>>(
      partials, (int)rows, nf, 4 * tri_base, mb, d_sph, d_tri, d_mats);
  return (int)cudaGetLastError();
}
