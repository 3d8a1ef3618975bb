"""The device operations one call enqueues, read from a CUDA graph.

``ops_a_call(prepare)`` captures one call into a CUDA graph without
running it and counts the graph's nodes through the driver API: every
kernel (by its mangled name), memset and copy the call puts on its
stream.  The one-kernel-a-call checks rest on it rather than on
torch.profiler, which on the H100 now and then records no event of a
one-kernel window.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

# CUgraphNodeType, less CU_GRAPH_NODE_TYPE_KERNEL (0): kernels go by name
NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "event wait", 7: "event record", 10: "mem alloc",
              11: "mem free"}


# the stream each device's captures run on, one for the process, whose
# kernel scratch (``kernels.make_stream_scratch``) is made before them
_CAPTURE_STREAMS: Dict[int, object] = {}


def ops_a_call(prepare: Callable[[], Callable[[], object]]) -> Dict[str, int]:
    """{kernel name or node type: count} of one call of ``prepare()``
    (it returns the call, its inputs made outside the capture).  The
    call is captured on a side stream and not run, so it changes no
    tensor; a call that synchronizes with the host cannot be captured
    and raises."""
    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(res, what):
        if res != 0:
            raise RuntimeError(f"ops_a_call: {what} returned CUresult {res}")

    from cilium_tpu_torch.kernels import make_stream_scratch

    fn = prepare()
    dev = torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
    make_stream_scratch(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream,
                          capture_error_mode="thread_local"):
        fn()
    graph, n = vp(g.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    got: Dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        name = NODE_TYPES.get(kind.value, f"node type {kind.value}")
        if kind.value == 0:  # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction
            # at offset 0, the CUkernel at offset 56
            params, cname = (vp * 16)(), ctypes.c_char_p()
            ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
               "cuGraphKernelNodeGetParams_v2")
            if params[0]:
                ok(cu.cuFuncGetName(ctypes.byref(cname), vp(params[0])),
                   "cuFuncGetName")
            else:
                ok(cu.cuKernelGetName(ctypes.byref(cname), vp(params[7])),
                   "cuKernelGetName")
            name = cname.value.decode()
        got[name] = got.get(name, 0) + 1
    g.reset()
    return got
