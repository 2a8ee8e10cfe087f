"""Product generators, one module per kind of product, each read by name
from a traffic mix's ``kind``: ``setup(cfg, traffic, seed, device,
trace=False)`` returns a product stream with ``warm()``, ``product(i)``
(issue product i, return its served result on the host),
``served_ok(served)``, ``shapes`` (per kernel work name, the shapes of one
launch), ``spans`` (name -> seconds, traced runs only), ``release()``
(free what the check does not need) and ``check()`` (the comparison with
the plain reference: a list of (name, number, limit))."""
