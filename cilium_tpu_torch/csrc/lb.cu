// K15 lb_stage_kernel and K16 lb6_stage_kernel: the per-packet service
// LB, v4 and v6.
//
// K15 replaces cilium_tpu/service/__init__.py lb_stage (:391), the jitted
// lb_stage_jit; K16 lb6_stage (:435), lb6_stage_jit.  The plain versions
// are cilium_tpu_torch/service/__init__.py lb_stage_plain and
// lb6_stage_plain.
//
// Bound: the rows read and written (~9 MB at 2^16 rows) and, for each
// hit row, its index slot, one Maglev gather (a row of 16381 int32 per
// frontend: the [S, m] table is 268 MB at 4096 frontends, so each gather
// is a cold 32 B sector) and one backend gather.  The lowest matching
// frontend needs only one probe a row into an index of the frontends.
//
// Design: one thread per row, its row loaded and stored as four 16-byte
// words.  K15 probes the host-built v4 index (lb.cuh lb_find4: 16-byte
// slots holding the key and its lowest frontend, so a probe step is one
// load) and K16 the v6 one (lb.cuh lb_find6: a v6 row's chain is its
// index slot, the frontend's words, the Maglev sector and the backend).
// Either chain is a few dependent reads from L2 whatever the number of
// frontends, with no staging and no block barrier; a row of the other
// family is only copied.  Then the hash, the Maglev gather, the backend
// gather and the rewritten row.  K15's old shared-memory scan of every
// frontend (a 24 KB tile and two block barriers a tile, until every row
// of the block matched) read all 4096 frontends in any block with a row
// to no VIP (PERF.md).
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
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Row r = load_row(io.rows, i);
  int32_t be = -1, svc = -1;
  if (r.d.y == 4) {
    svc = lb_find4(t, r.b.w, r.c.y, r.c.z);
    be = lb_pick(t.maglev, t.m, svc,
                 lb_hash4(r.a.w, r.c.x, r.b.w, r.c.y, r.c.z));
  }
  if (be >= 0) {
    r.b.w = __ldg(t.backend_ip + be);
    r.c.y = __ldg(t.backend_port + be);
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
