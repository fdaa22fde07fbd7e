"""Checkpoint/restart training loop and straggler watchdog (one device)."""
