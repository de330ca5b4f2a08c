"""What a traffic mix drives on the port, and how its outputs are judged.

An entry module has ``ops(cfg)``, the public ops one batch calls (their
bounds are ``bounds/<op>.py``), ``program(ap, cfg)``, which returns the call
the window times (a batch ``(B, L)`` in, a dict of the port's outputs out),
and ``compare(out, ref, cfg)``, the numbers that decide ``correct``; its
reference is ``reference/<entry>.py``."""
