"""Entry points: the population trainer (with the halving lifecycle and
the refill search), the population server, the kernel-launch budget, the
paper's Tables 1–2 (``paper_tables``) and the host mesh of a job on
several ranks (``mesh``)."""
