"""Distillation training of the PyTorch port: losses' step, masked AdamW, schedules."""
