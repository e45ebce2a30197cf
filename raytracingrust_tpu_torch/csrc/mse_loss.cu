// Fused render -> MSE -> gradient kernel for scenes of spheres and
// triangles, written for Hopper (sm_90a): one launch gives the fit step's
// loss and its gradient.
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_mse_kernel
// (reached through run_fused in _mse_cvjp, mse_loss_pallas).  It computes
//   loss = mean over pixels and channels of (m - target)^2,
//   m    = mean over the pixel's spp samples of clip(radiance, 0, clamp),
// and d loss / d fparams, (K,) float32.  Variants: solid spheres, kExt
// (mixes, volumes, the isotropic lobe), kTri (triangles, whose materials'
// cotangents go to their slots' rows, radiance_grad.cu), both.  A sky map
// never comes here: its fit takes the forward kernel and the radiance
// gradient kernel, as the TPU package's fused kernel excludes it
// (supports_fused_mse).  Any spp >= 1; depth at most kMaxTape = 12.
//
// Threads: one thread a sample.  Ray id = pixel * spp + s, as prep_rays and
// the TPU kernel number them, so a pixel's samples sit on consecutive lanes,
// as in the TPU kernel's lane groups.  The group is the unpadded segment of
// n = min(spp, kThreads) lanes (the TPU kernel pads its group to a power of
// two; here a pad lane would idle through every bounce):
//   spp <= 32:  a warp holds floor(32 / spp) whole pixels, its last
//               32 mod spp lanes idle (2 of 32 at spp 5);
//   spp <= 128: a block holds floor(kThreads / spp) whole pixels (2 at
//               spp 48, its last 32 lanes idle);
//   spp > 128:  a block holds one pixel, lane t takes samples t, t + 128,
//               ... (at most ceil(spp / 128) each).
// The first case is the kernel's kWarp instance, the others its general
// one.  A block takes pixels_per_block(spp) pixels at a time, grid-stride
// over the frame's pixels on at most `max_blocks` blocks (one row of
// partials each).  Each thread runs the recording trace of its sample
// once, keeping its tape, and clips the radiance.  Above 128 samples a
// thread first traces its later samples (into the same tape, which the
// next trace overwrites) and its first sample last; after the pixel's mean
// the later ones are traced again for their adjoints.
//
// The pixel mean, in a fixed order without atomics: for spp <= 32 a
// segmented tree over the group's lanes with __shfl_down_sync (a lane adds
// the lane `off` above it while both lie in the segment, off = the largest
// power of two below n, then halving), and the segment's first lane's total
// to every lane of the group by __shfl_sync; above 32 each thread's clipped
// sum goes to shared memory between two barriers and every lane of the
// pixel adds its group's entries in lane order.  Every lane of the group so
// holds the same total, m = total / spp, and the same error e = m - target;
// the group's first lane adds e . e to its loss sum, and each lane runs
// radiance.cuh's adjoint from its tape with the cotangent
//   g = 2 e / (3 H W spp) * clip'(radiance),
// where clip' is 1 inside (0, clamp), 1/2 at a sample exactly on 0 or on
// clamp (jnp.clip's rule, and the plain version's torch.minimum/maximum),
// and 0 outside; a sample whose three channels get 0 skips it.  Every lane,
// idle and tail lanes included, runs each loop iteration to its shuffles
// and barriers: the trip count is the block's.
//
// The pipeline: a warp's lanes wait at the mean for the slowest trace of
// the warp.  So a thread keeps two tapes, and runs the adjoints of the
// pixel of its last iteration after this iteration's trace, before the
// wait: a lane whose trace ends early goes on with the other, independent
// work, and the warp interleaves the two (on the H100 the zoo's fit shape
// took 10.7 ms with one tape and 4.7 ms with two, scripts/profile_mse_loss.py).
// One iteration past the frame runs the last adjoints.  The frame is the
// two tapes, 1,008 bytes of local memory a thread.
//
// The sums over samples: as in radiance_grad.cu (head entries in registers
// and warp shuffles, sphere and slot entries in the block's shared sums by
// shared-memory atomics, in no fixed order, one row of partials per block,
// a second kernel adding the rows in order), with the pixel's squared error
// as one more entry; that kernel divides it by 3 H W.
//
// What bounds it on this card: the per-ray FP32 work of one recording
// forward and one reverse sweep, the tape's local-memory traffic (40 bytes
// a bounce, written once and read once, mostly from L1), and the latency
// of their dependent chains at 4 blocks of 128 threads an SM (110-128
// registers); the lanes of a warp diverge where their paths do.  Device
// memory traffic is 12 bytes of target per pixel.

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

constexpr unsigned kFull = 0xffffffffu;
// at least 4 blocks an SM: at most 128 registers a thread, which every
// variant needs without a spill (without it ptxas took 96 for one and
// spilled)
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float clip(float x, float hi) {
  return fminf(fmaxf(x, 0.0f), hi);
}

__device__ __forceinline__ float clip_slope(float x, float hi) {
  if (x > 0.0f && x < hi) return 1.0f;
  return (x == 0.0f || x == hi) ? 0.5f : 0.0f;
}

// Lanes of one pixel's group.
__host__ __device__ inline int group_lanes(int spp) {
  return spp < kThreads ? spp : kThreads;
}

// Pixels a block takes at a time.
__host__ __device__ inline int pixels_per_block(int spp) {
  const int n = group_lanes(spp);
  return n <= 32 ? (kThreads / 32) * (32 / n) : kThreads / n;
}

// The sum of v over the n lanes of this lane's segment (its position sl in
// it, its first lane head), on every lane of the segment; n <= 32,
// segments start at multiples of n.  A fixed tree over the segment's lanes
// (a value shuffled from outside it is never added); every lane of the
// warp takes part.  Shuffles over the segment's lanes alone, which let the
// groups of a warp drift apart, took longer on the H100.
__device__ __forceinline__ float segment_sum(float v, int sl, int n, int off0,
                                             int head) {
  for (int off = off0; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (sl < off && sl + off < n) v += o;
  }
  return __shfl_sync(kFull, v, head);
}

// kWarp (spp <= 32): a group lies in one warp, its pixel mean by shuffles,
// one sample a thread, and the loop body holds no barrier and no loop
// around an adjoint.  Otherwise the group sum goes through shared memory
// between two barriers, and a thread loops over its samples.
template <bool kExt, bool kTri, bool kWarp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mse_kernel(const float* __restrict__ fparams, const int* __restrict__ kinds,
           Rows rows, uint32_t k0, uint32_t k1, int n_pixels, int spp,
           int width, int max_depth, int bg_kind, int clay, float clamp,
           const float* __restrict__ target, float* __restrict__ partials) {
  __shared__ GradShared<kExt, kTri> sh;
  // above 32 samples: each lane's clipped sum
  __shared__ float lane_sum[kWarp ? 1 : kThreads][3];
  load_scene(sh, fparams, kinds, rows);
  const Sky no_sky{nullptr, 0, 0};
  float head[kHead];
#pragma unroll
  for (int k = 0; k < kHead; ++k) head[k] = 0.0f;
  float sse = 0.0f;
  // d loss / d m = 2 (m - target) / (3 H W); the mean over samples adds 1/spp
  const float scale = 2.0f / (3.0f * (float)n_pixels) / (float)spp;

  // this thread's place: its pixel's slot in the block's pixels (-1: an
  // idle lane), its first sample s0, its group's first lane
  const int n = group_lanes(spp);
  const int per_block = pixels_per_block(spp);
  const int t = threadIdx.x;
  int slot, s0, head_lane;
  if (kWarp) {
    const int lane = t & 31, per_warp = 32 / n;
    slot = lane / n < per_warp ? (t >> 5) * per_warp + lane / n : -1;
    s0 = lane % n;
    head_lane = lane - s0;
  } else {
    slot = t / n < per_block ? t / n : -1;
    s0 = t % n;
    head_lane = t - s0;
  }
  int off0 = 1;  // the largest power of two below n
  while (2 * off0 < n) off0 *= 2;

  // Two tapes: this iteration's samples trace into tapes[cur] while the
  // adjoints of the last iteration's pixel (`pending`) run from
  // tapes[cur ^ 1], before this pixel's mean waits on its group.  One more
  // iteration past the frame runs the last adjoints.
  Tape tapes[2];
  int cur = 0;
  bool pending = false;
  int p_pixel = 0;                           // the pending pixel
  float p_cr = 0.0f, p_cg = 0.0f, p_cb = 0.0f;  // its cotangent scale
  float p_gr = 0.0f, p_gg = 0.0f, p_gb = 0.0f;  // sample s0's cotangent
  for (long long base = (long long)blockIdx.x * per_block;;
       base += (long long)gridDim.x * per_block) {
    const bool more = base < n_pixels;  // the block's: uniform
    const long long p = base + slot;
    const bool active = more && slot >= 0 && p < n_pixels;
    const int pixel = active ? (int)p : 0;
    float px = (float)(pixel % width), py = (float)(pixel / width);
    float r0 = 0.0f, g0 = 0.0f, b0 = 0.0f;  // sample s0's radiance
    float sr = 0.0f, sg = 0.0f, sb = 0.0f;  // this lane's clipped sum
    if (active) {
      if (!kWarp) {  // above kThreads samples, the later ones first
        for (int s = s0 + n; s < spp; s += n) {
          float r, g, b;
          trace<true, kExt, false, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                         (uint32_t)(pixel * spp + s), px,
                                         py, max_depth, bg_kind, clay,
                                         no_sky, r, g, b, &tapes[cur]);
          sr += clip(r, clamp);
          sg += clip(g, clamp);
          sb += clip(b, clamp);
        }
      }
      trace<true, kExt, false, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                     (uint32_t)(pixel * spp + s0), px, py,
                                     max_depth, bg_kind, clay, no_sky, r0,
                                     g0, b0, &tapes[cur]);
      sr += clip(r0, clamp);
      sg += clip(g0, clamp);
      sb += clip(b0, clamp);
    }
    if (pending) {  // the last pixel's adjoints, s0's from the tape held
      const float qx = (float)(p_pixel % width), qy = (float)(p_pixel / width);
      Tape& held = tapes[cur ^ 1];
      if (p_gr != 0.0f || p_gg != 0.0f || p_gb != 0.0f)
        adjoint<kExt, false, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                   (uint32_t)(p_pixel * spp + s0), qx, qy,
                                   bg_kind, clay, no_sky, held, p_gr, p_gg,
                                   p_gb, head, sh.gs, nullptr);
      if (!kWarp) {  // the later samples, each traced again for its tape
        for (int s = s0 + n; s < spp; s += n) {
          const uint32_t rid = (uint32_t)(p_pixel * spp + s);
          float r, g, b;
          trace<true, kExt, false, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                         rid, qx, qy, max_depth, bg_kind,
                                         clay, no_sky, r, g, b, &held);
          const float gr = p_cr * clip_slope(r, clamp),
                      gg = p_cg * clip_slope(g, clamp),
                      gb = p_cb * clip_slope(b, clamp);
          if (gr != 0.0f || gg != 0.0f || gb != 0.0f)
            adjoint<kExt, false, kTri>(sh.f, sh.kind_of, rows, k0, k1, rid,
                                       qx, qy, bg_kind, clay, no_sky, held,
                                       gr, gg, gb, head, sh.gs, nullptr);
        }
      }
    }
    if (!more) break;
    float mr, mg, mb;  // the pixel's total, on every lane of its group
    if (kWarp) {
      mr = segment_sum(sr, s0, n, off0, head_lane);
      mg = segment_sum(sg, s0, n, off0, head_lane);
      mb = segment_sum(sb, s0, n, off0, head_lane);
    } else {
      lane_sum[t][0] = sr;
      lane_sum[t][1] = sg;
      lane_sum[t][2] = sb;
      __syncthreads();
      mr = mg = mb = 0.0f;
      if (active)
        for (int l = head_lane; l < head_lane + n; ++l) {
          mr += lane_sum[l][0];
          mg += lane_sum[l][1];
          mb += lane_sum[l][2];
        }
      __syncthreads();  // lane_sum is written again next iteration
    }
    pending = active;
    if (!active) continue;
    const float er = mr / (float)spp - target[3 * p],
                eg = mg / (float)spp - target[3 * p + 1],
                eb = mb / (float)spp - target[3 * p + 2];
    if (s0 == 0) sse += er * er + eg * eg + eb * eb;
    p_pixel = pixel;
    p_cr = er * scale;
    p_cg = eg * scale;
    p_cb = eb * scale;
    p_gr = p_cr * clip_slope(r0, clamp);
    p_gg = p_cg * clip_slope(g0, clamp);
    p_gb = p_cb * clip_slope(b0, clamp);
    cur ^= 1;
  }
  write_partials(sh, head, sse, rows, scene_floats(rows) + 1, partials);
}

}  // namespace

// Plain C entry, bound with ctypes (ops/mse_loss.py).  Launches the fused
// kernel on at most `max_blocks` blocks, then the row sum, on `stream`.
// `target` is (n_pixels, 3); `out` gets the K gradient entries of fparams
// and then the loss; `partials` holds max_blocks rows of K + 1 floats.
// `ext`, `mix`, `n_vol` and the triangles as rtrt_radiance's; no sky map.
// Returns cudaGetLastError() of the launches.
extern "C" int rtrt_mse_loss(const float* fparams, const int* kinds,
                             int n_spheres, uint32_t k0, uint32_t k1,
                             int n_pixels, int spp, int width, int max_depth,
                             int bg_kind, int clay, int ext, int mix,
                             int n_vol, const float* tri, int n_tri,
                             int n_tm, float clamp, const float* target,
                             float* partials, int max_blocks, float* out,
                             void* stream) {
  if (!rows_ok(n_spheres, ext, mix, n_vol, tri, n_tri, n_tm) ||
      n_pixels < 1 || spp < 1 ||
      width < 1 || max_depth < 0 || max_depth > kMaxTape || max_blocks < 1 ||
      bg_kind == kSkyMap || (long long)n_pixels * spp >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Rows rows = make_rows(n_spheres, mix, n_vol, tri, n_tri, n_tm);
  const int n_out = scene_floats(rows) + 1;
  const int per_block = pixels_per_block(spp);
  const long long need = ((long long)n_pixels + per_block - 1) / per_block;
  const int blocks = need < max_blocks ? (int)need : max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = with_flags(ext, n_tri > 0, [&](auto e, auto t) {
    constexpr bool kE = decltype(e)::value, kT = decltype(t)::value;
    if (spp <= 32)
      mse_kernel<kE, kT, true><<<blocks, kThreads, 0, s>>>(
          fparams, kinds, rows, k0, k1, n_pixels, spp, width, max_depth,
          bg_kind, clay, clamp, target, partials);
    else
      mse_kernel<kE, kT, false><<<blocks, kThreads, 0, s>>>(
          fparams, kinds, rows, k0, k1, n_pixels, spp, width, max_depth,
          bg_kind, clay, clamp, target, partials);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  reduce_partials_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      partials, blocks, n_out, 3.0f * (float)n_pixels, out);
  return (int)cudaGetLastError();
}
