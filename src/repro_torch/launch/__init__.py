"""Entry points: the population server and the kernel-launch budget."""
