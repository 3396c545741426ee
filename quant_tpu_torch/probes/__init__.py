"""Chip probes: the card's matmul, conv and elementwise rates, the stem
forms, the served model's batch sweep and the port's probe kernels
(`python -m quant_tpu_torch.probes.probe_r2 --list`, `... probe_r3`)."""
