"""The node's service plane: egress NAT (``nat.py``).

The JAX package's ``service/`` also holds the service load balancer
(frontends, Maglev, the socket-LB flow cache); that part is not ported
yet (ROADMAP A8b, B13), so the port's daemon has no service table.
"""
