// K10: an in-place dynamic_update_slice into a live table -- the engine
// of every table patch (one identity's verdict rows, its auth column,
// one LPM block or l1 cell).
//
// Replaces: cilium_tpu/datapath/loader.py _dus (:56), the jitted
// donating jax.lax.dynamic_update_slice.  The plain version is
// datapath/loader.py _dus_plain.
//
// Each start is first taken as jax.lax.dynamic_update_slice takes it: a
// negative start counts from the end once (allow_negative_indices),
// then XLA clamps it into [0, dst - upd], so a start past the edge
// writes the last window that fits.  Then every update element lands
// at its offset.
//
// Design: one thread per update element, grid-stride; the update's
// 4-D coordinate comes from its flat index, the destination offset from
// the clamped starts and the destination's row-major strides.  A patch
// moves a few KB (a verdict row is [n_pol, 2, 1, 256] int32, an LPM
// block 1 KB), so the kernel is bound by its launch, not by bytes or
// operations.  It runs on the stream of the serve steps (the loader
// enters it), so it lands after every step enqueued before it and
// before every step enqueued after it.
#include "views.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

__global__ void dus_kernel(DusIO io) {
  int64_t start[4], stride[4];
  int64_t s = 1;
  for (int d = 3; d >= 0; --d) {
    int64_t hi = io.dst_shape[d] - io.upd_shape[d];
    int64_t v = io.starts[d];
    if (v < 0) v += io.dst_shape[d];
    start[d] = v < 0 ? 0 : (v > hi ? hi : v);
    stride[d] = s;
    s *= io.dst_shape[d];
  }
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < io.n;
       e += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = e, off = 0;
    for (int d = 3; d >= 0; --d) {
      int64_t c = r % io.upd_shape[d];
      r /= io.upd_shape[d];
      off += (c + start[d]) * stride[d];
    }
    io.dst[off] = io.upd[e];
  }
}

}  // namespace

extern "C" int dus_launch(const DusIO* io, cudaStream_t stream) {
  if (io->n > 0) {
    int64_t blocks = (io->n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dus_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t tables_abi_size(int which) {
  return which == 0 ? sizeof(DusIO) : 0;
}
