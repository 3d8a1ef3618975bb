"""The datapath on torch: ipcache LPM, conntrack, the verdict step and
the loader.  On the card each stage runs in a CUDA kernel (``csrc/``);
see ``verdict.datapath_step`` for the fused step and
``loader.TorchLoader`` for the agent-facing seam."""
