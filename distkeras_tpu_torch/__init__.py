"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

The JAX package stays the reference; this package re-implements it slice
by slice in PyTorch for NVIDIA Hopper (``sm_90a``), with hand-written
kernels where the JAX package wrote Pallas kernels for the TPU. It imports
``torch`` and never ``jax`` or anything of ``distkeras_tpu``.

The first slice is paged generative serving of a causal LM::

    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import GenerationEngine

    model = gpt_small()
    init_params(model, torch.Generator().manual_seed(0))
    with GenerationEngine(model, page_size=16, num_slots=8) as eng:
        result = eng.generate(prompt, max_new_tokens=32).result()

The second slice is training a causal LM through the step engine, with
the flash-attention kernels forward and backward::

    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params
    from distkeras_tpu_torch.ops import optimizers

    model = init_params(CausalLM(vocab_size=50304, attention="flash"),
                        torch.Generator().manual_seed(0))
    tx = optimizers.get("adamw", 1e-3)
    state = engine.create_train_state(model, tx)
    step = engine.make_train_step(model, "masked_lm", tx)
    state, metrics = step(state, {"features": ids, "labels": labels})

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(see :func:`distkeras_tpu_torch.device.resolve_device`).

Importing this package is light: submodules load on first use.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
