"""Cross-cutting plumbing copied from the JAX package: named
controllers (``controller``), debounced triggers (``trigger``) and the
serving plane's deterministic fault injector (``faults``)."""
