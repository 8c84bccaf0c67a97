"""repro_torch: the PyTorch/CUDA port of the GeNN reproduction.

It mirrors the layout of the JAX package ``repro`` (which stays the
reference) module for module:

  repro_torch.core       -- SNN codegen, simulator, ModelSpec, conductance
                            scaling, the Izhikevich cortical net
  repro_torch.sparse     -- ELL synapse containers, host initializers and
                            the paper's eq. (1)/(2) memory model
  repro_torch.kernels    -- hand-written CUDA kernels for Hopper (sm_90a),
                            their plain PyTorch versions and the dispatch
  repro_torch.models     -- the LM family (dense, Mamba2), its loss
  repro_torch.launch     -- the token server and the trainer
  repro_torch.optim      -- AdamW and LR schedules
  repro_torch.data       -- the deterministic token pipeline
  repro_torch.convert    -- loads arrays exported from a ``repro`` model

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
tensor on the CPU takes each kernel's plain version, a CUDA tensor its
kernel.  This package imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"
