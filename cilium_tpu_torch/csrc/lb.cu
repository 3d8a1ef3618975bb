// K15 lb_stage_kernel and K16 lb6_stage_kernel: the per-packet service
// LB, v4 and v6.
//
// K15 replaces cilium_tpu/service/__init__.py lb_stage (:391), the jitted
// lb_stage_jit; K16 lb6_stage (:435), lb6_stage_jit.  The plain versions
// are cilium_tpu_torch/service/__init__.py lb_stage_plain and
// lb6_stage_plain.
//
// Bound: the rows read and written (~9 MB at 2^16 rows), the frontends
// read once, one Maglev gather (a row of 16381 int32 per frontend: the
// [S, m] table is 268 MB at 4096 frontends, so each gather is a cold
// 32 B sector) and one backend gather per hit row.  The lowest matching
// frontend needs only one probe a row into an index of the frontends.
//
// Design: one thread per row, its row loaded and stored as four 16-byte
// words.  K15 scans the v4 frontends up to each row's first match, as
// the reference's [N, S] compare does: a block of 256 rows stages them
// into shared memory a 24 KB tile at a time (lb.cuh lb_match4), every
// thread scans the tile (the same entry for all lanes: a broadcast),
// keeps its lowest match, and the block moves to the next tile only
// while some thread is still unmatched.  K16 probes the host-built v6
// index (lb.cuh lb_find6): a v6 row's chain is its index slot, the
// frontend's words, the Maglev sector and the backend, four dependent
// reads from L2 whatever the number of frontends, with no staging and
// no block barrier; a row that is not v6 is only copied.  Then the hash,
// the Maglev gather, the backend gather and the rewritten row.
#include "lb.cuh"

namespace {

constexpr int N_COLS = 16;

struct Row {
  uint4 a, b, c, d;  // src[4]; dst[4]; sport dport proto flags; len fam ep dir
};

__device__ __forceinline__ Row load_row(const uint32_t* rows, int32_t i) {
  const uint4* r = reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS);
  return Row{r[0], r[1], r[2], r[3]};
}

__device__ __forceinline__ void store_row(uint32_t* out, int32_t i,
                                          const Row& r) {
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)i * N_COLS);
  o[0] = r.a;
  o[1] = r.b;
  o[2] = r.c;
  o[3] = r.d;
}

__global__ void __launch_bounds__(LB_TPB) lb_stage_kernel(LbIO io, LbView t) {
  __shared__ LbTile4 tile;
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  bool in = i < io.n;
  Row r{};
  if (in) r = load_row(io.rows, i);
  int32_t svc = lb_match4(t, tile, in && r.d.y == 4, r.b.w, r.c.y, r.c.z);
  if (!in) return;
  int32_t be = lb_pick(t.maglev, t.m, svc,
                       lb_hash4(r.a.w, r.c.x, r.b.w, r.c.y, r.c.z));
  if (be >= 0) {
    r.b.w = t.backend_ip[be];
    r.c.y = t.backend_port[be];
  }
  store_row(io.out, i, r);
  io.have_backend[i] = be >= 0;
  io.no_backend[i] = svc >= 0 && be < 0;
}

__global__ void __launch_bounds__(LB_TPB) lb6_stage_kernel(LbIO io,
                                                           Lb6View t) {
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Row r = load_row(io.rows, i);
  int32_t be = -1, svc = -1;
  if (r.d.y == 6) {
    svc = lb_find6(t, r.b, r.c.y, r.c.z);
    const uint32_t src[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
    be = lb_pick(t.maglev, t.m, svc,
                 lb_hash6(src, r.c.x, r.b.w, r.c.y, r.c.z));
  }
  if (be >= 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(t.backend_ip) + be);
    r.b = w;
    r.c.y = __ldg(t.backend_port + be);
  }
  store_row(io.out, i, r);
  io.have_backend[i] = be >= 0;
  io.no_backend[i] = svc >= 0 && be < 0;
}

inline int blocks_for(int32_t n) { return (n + LB_TPB - 1) / LB_TPB; }

}  // namespace

extern "C" int lb_stage_launch(const LbIO* io, const LbView* t,
                               cudaStream_t stream) {
  if (io->n > 0)
    lb_stage_kernel<<<blocks_for(io->n), LB_TPB, 0, stream>>>(*io, *t);
  return (int)cudaGetLastError();
}

extern "C" int lb6_stage_launch(const LbIO* io, const Lb6View* t,
                                cudaStream_t stream) {
  if (io->n > 0)
    lb6_stage_kernel<<<blocks_for(io->n), LB_TPB, 0, stream>>>(*io, *t);
  return (int)cudaGetLastError();
}

extern "C" size_t lb_abi_size(int which) {
  switch (which) {
    case 0: return sizeof(LbView);
    case 1: return sizeof(Lb6View);
    case 2: return sizeof(LbIO);
    default: return 0;
  }
}
