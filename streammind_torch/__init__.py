"""streammind-torch: the StreamMind streaming stack in PyTorch for NVIDIA Hopper.

A second package beside the JAX/Pallas package, holding the same
main path: one live stream through ``streaming.StreamSession`` — per frame
CLIP ViT-L/14-336 → Mamba temporal projector → 2-way gate LM, and on a
gate fire a cached Mistral-7B prefill and greedy or sampled decode.

Module and function names follow the JAX package, and the parameter tree
is the same (leaf names, ``(out, in)`` weight layout, layer-stacked
leaves), so ``utils.from_jax.params_from_numpy`` carries its weights over.
The Pallas kernels of that path are hand-written CUDA kernels here
(``csrc/``, built at first use by ``ops._build``); each wrapper takes its
plain PyTorch version only for tensors that lie on the CPU.

The public API has the JAX package's shapes, ``model_init``, ``infer`` and
``x_infer`` at the top level (``api`` holds ``infer_beams`` too), and the
HTTP plane is ``serve.controller`` / ``serve.model_worker`` / ``serve.cli``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

_API = ("model_init", "infer", "x_infer")


def __getattr__(name):  # lazy: `import streammind_torch.ops` stays light
    if name in _API:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
