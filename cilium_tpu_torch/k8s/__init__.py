"""Kubernetes integration: the watchers that translate k8s objects into
agent mutations (``watchers.py``: Services and Endpoints into the
``ServiceManager``).  The informer, the CNP translation and the other
watchers are not ported yet (ROADMAP A6, A20)."""
