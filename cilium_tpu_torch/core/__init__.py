"""Header-tensor core: the packet schema of the datapath."""
