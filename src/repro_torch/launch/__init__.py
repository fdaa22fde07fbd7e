"""Entry points: the population server, the kernel-launch budget and the
paper's Tables 1–2 (``paper_tables``)."""
