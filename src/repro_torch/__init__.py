"""PyTorch/CUDA port of the DRIM reproduction (`src/repro/` is the JAX
reference it is tested against, module for module).

The main path: a traced or hand-built `BulkGraph` is compiled to one fused
AAP stream (`pim.compiler`), staged as word tiles, replayed wave by wave
by the "resident" (plain torch) or "cuda" (AAP interpreter kernel) engine,
and decoded to int32 dots (`pim.bnn`).  `models.layers.BitLinear` serves
through it or through the packed XNOR-popcount kernel.  Entry points run
on the CUDA card unless the caller passes `device="cpu"`.
"""
from repro_torch.device import resolve_device
