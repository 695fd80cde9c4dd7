"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set lower runs slower, so the
result's ``device`` carries the limit it ran at)."""

F32_FLOPS = 67e12     # float32 outside the tensor cores
HBM_BYTES = 3.35e12   # bytes/s
