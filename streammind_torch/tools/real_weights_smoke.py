"""Released-checkpoint smoke check: one command that runs a StreamMind
checkpoint directory through the port and holds it against ``transformers``'
models built from the same tensors.

    python -m streammind_torch.tools.real_weights_smoke --model-path DIR \\
        [--model-base DIR] [--video FILE] [--tol 2e-4] [--max-new-tokens 32] \\
        [--device cuda]

  1. One frame: the port's fp32 ViT features (hidden layer -2, CLS dropped)
     against ``transformers.CLIPVisionModel`` loaded from the checkpoint's
     ``model.vision_tower.vision_tower.*`` tensors, then a one-turn caption
     through ``api.infer``.
  2. The decoder's fp32 prefill logits of 16 ids against
     ``transformers.MistralForCausalLM`` built from the decoder's tensors,
     then an 8-frame open-ended QA through ``api.x_infer`` (the frames of
     ``--video`` where given, else seeded).

The port's side runs on ``--device``, the mirrors on the CPU; TF32 is off
for the whole run (an fp32 matmul under TF32 misses 2e-4 by 10-40x) and
restored after.  It prints a ``{"deltas": ..., "tol": ...}`` line and
``OK: all deltas within tol``; it exits 1 when a delta is over ``--tol``
(relative rms) and 2, naming the package, when ``transformers`` is not
installed.  A Mixtral decoder skips the logits delta; a checkpoint without a
tokenizer skips the caption and the QA.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time

import numpy as np
import torch

_VISION = "model.vision_tower.vision_tower."


def _rms(a, b) -> float:
    """Relative rms of a - b, over the rms of b."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    denom = float(np.sqrt(np.mean(b * b))) or 1.0
    return float(np.sqrt(np.mean((a - b) ** 2))) / denom


def _load_sd(model_path: str, base_path=None) -> dict:
    """The checkpoint's tensors (over the base's, where one is given)."""
    from ..utils.convert import load_state_dict

    sd = load_state_dict(model_path)
    if base_path:
        base = load_state_dict(base_path)
        base.update(sd)
        sd = base
    return sd


@contextlib.contextmanager
def tf32_matmuls(on: bool):
    """TF32 on or off for matmuls and cuDNN inside the block; the settings
    restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


fp32_matmuls = functools.partial(tf32_matmuls, False)   # TF32 off inside the block


def load_model(model_path: str, model_base=None, device="cuda", tokenizer=None):
    """``api.model_init`` in fp32: (model, processor, tokenizer, version)."""
    from ..api import model_init

    return model_init(model_path, dtype=torch.float32, model_base=model_base,
                      tokenizer=tokenizer, device=device)


def _device(tree) -> torch.device:
    from ..utils.params import tree_leaves

    return next(tree_leaves(tree)).device


@torch.no_grad()
def vision_features(model, pixels) -> np.ndarray:
    """The port's ViT features of (B, 3, H, W) pixels at the config's
    selected layer, CLS dropped, on the device of the model's tree."""
    from ..models.vit import vit_forward

    vision = model.params["vision"]
    x = torch.as_tensor(np.asarray(pixels, np.float32)).to(_device(vision))
    return vit_forward(vision, model.cfg.vision, x).float().cpu().numpy()


@torch.no_grad()
def decoder_logits(model, token_ids) -> np.ndarray:
    """The port's (S, vocab) fp32 logits of one prompt (no cache)."""
    from ..models import mistral as lm

    text = model.params["text"]
    ids = torch.as_tensor(np.asarray(token_ids, np.int64)[None]).to(_device(text))
    logits, _ = lm.text_forward(text, model.cfg.text, input_ids=ids)
    return logits[0].float().cpu().numpy()


def _mirror(cls, conf, sd: dict):
    """A ``transformers`` model of class ``cls`` holding ``sd`` in fp32, in
    eval mode on the CPU.  ``from_pretrained`` with a state dict places the
    tensors without first drawing the random weights they replace (about
    15 s at StreamMind-7B's widths); it reports keys the model lacks."""
    return cls.from_pretrained(None, config=conf, attn_implementation="eager",
                               state_dict={k: t.float() for k, t in sd.items()}).eval()


def clip_mirror_features(cfg, sd, pixels) -> np.ndarray:
    """``transformers.CLIPVisionModel`` from the checkpoint's vision tensors,
    on the CPU: hidden state ``select_layer``, CLS dropped."""
    import transformers

    v = cfg.vision
    conf = transformers.CLIPVisionConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
        image_size=v.image_size, patch_size=v.patch_size)
    mirror = _mirror(transformers.CLIPVisionModel, conf,
                     {k[len(_VISION):]: t for k, t in sd.items() if k.startswith(_VISION)})
    with torch.no_grad():
        hs = mirror(torch.as_tensor(np.asarray(pixels, np.float32)),
                    output_hidden_states=True).hidden_states
    return hs[v.select_layer][:, 1:].numpy()


def mistral_mirror_logits(cfg, sd, token_ids) -> np.ndarray:
    """``transformers.MistralForCausalLM`` from the decoder's tensors, on the
    CPU: the (S, vocab) logits of one prompt."""
    import transformers

    t = cfg.text
    conf = transformers.MistralConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        intermediate_size=t.intermediate_size, num_hidden_layers=t.num_layers,
        num_attention_heads=t.num_heads, num_key_value_heads=t.num_kv_heads,
        head_dim=t.head_dim, rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
        max_position_embeddings=t.max_position_embeddings,
        tie_word_embeddings=t.tie_word_embeddings)
    mirror = _mirror(transformers.MistralForCausalLM, conf, {
        k: v for k, v in sd.items()
        if (k.startswith("model.") and not k.startswith(("model.mm_projector",
                                                          "model.vision_tower")))
        or k.startswith("lm_head")})
    with torch.no_grad():
        return mirror(torch.as_tensor(np.asarray(token_ids, np.int64)[None])).logits[0].numpy()


def check_vision(model, sd, pixels) -> float:
    """The port's fp32 ViT features against the CLIP mirror (relative rms)."""
    return _rms(vision_features(model, pixels), clip_mirror_features(model.cfg, sd, pixels))


def check_decoder(model, sd, token_ids) -> float:
    """The port's fp32 prefill logits against the Mistral mirror (relative
    rms); 0 for a Mixtral decoder, which has no mirror here."""
    if model.cfg.text.num_experts > 1:
        print("[decoder] mixtral mirror not wired in the smoke tool; "
              "skipping logits delta (projector/vision deltas still run)")
        return 0.0
    return _rms(decoder_logits(model, token_ids), mistral_mirror_logits(model.cfg, sd, token_ids))


def caption(model, pixels, tokenizer, version: str, max_new_tokens: int) -> str:
    """Config 1's one-turn caption of a frame."""
    from ..api import infer

    return infer(model, pixels, "Describe the image.", tokenizer, version=version,
                 max_new_tokens=max_new_tokens)


def video_qa(model, video, tokenizer, version: str) -> str:
    """Config 2's open-ended question about a clip."""
    from ..api import x_infer

    return x_infer(video, "What is happening in this video?", model, tokenizer,
                   mode="openend", version=version)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True, help="released checkpoint directory")
    parser.add_argument("--model-base", default=None,
                        help="base decoder dir for LoRA / projector-only checkpoints")
    parser.add_argument("--video", default=None,
                        help="optional video file for config 2 (seeded frames when omitted)")
    parser.add_argument("--tol", type=float, default=2e-4,
                        help="max relative-rms delta against the transformers mirrors")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    try:
        import transformers  # noqa: F401
    except ImportError:
        print("real_weights_smoke: the deltas need the `transformers` package (its "
              "CLIPVisionModel and MistralForCausalLM are the mirrors), which is not "
              "installed", file=sys.stderr)
        return 2

    with fp32_matmuls():
        t0 = time.time()
        model, processor, tokenizer, version = load_model(args.model_path, args.model_base,
                                                          args.device)
        print(f"[load] {args.model_path} converted in {time.time() - t0:.1f}s "
              f"(fp32, version={version}, device={args.device})")
        sd = _load_sd(args.model_path, args.model_base)

        rng = np.random.default_rng(0)
        size = model.cfg.vision.image_size
        deltas = {}

        # -- config 1: one frame -> ViT features + a one-turn caption -----------
        pixels = rng.standard_normal((1, 3, size, size)).astype(np.float32)
        if any(k.startswith("model.vision_tower.") for k in sd):
            t0 = time.time()
            deltas["vit_feature_rms"] = check_vision(model, sd, pixels)
            print(f"[config1] ViT fp32 feature rms delta {deltas['vit_feature_rms']:.2e} "
                  f"({time.time() - t0:.1f}s)")
        else:
            print("[config1] checkpoint carries no vision tower; ViT delta skipped "
                  "(pass a full-SFT dir to check it)")
        if tokenizer is not None:
            t0 = time.time()
            text = caption(model, pixels, tokenizer, version, args.max_new_tokens)
            print(f"[config1] caption ({time.time() - t0:.1f}s): {text!r}")

        # -- config 2: decoder logits + an 8-frame video QA ---------------------
        prompt_ids = list(range(1, 17))
        t0 = time.time()
        deltas["decoder_logits_rms"] = check_decoder(model, sd, prompt_ids)
        print(f"[config2] decoder fp32 prefill-logits rms delta "
              f"{deltas['decoder_logits_rms']:.2e} ({time.time() - t0:.1f}s)")
        if tokenizer is not None:
            if args.video:
                video = processor(args.video)
            else:
                video = rng.standard_normal((8, 3, size, size)).astype(np.float32)
            t0 = time.time()
            answer = video_qa(model, video, tokenizer, version)
            print(f"[config2] 8-frame QA ({time.time() - t0:.1f}s): {answer!r}")
        else:
            print("[config2] no tokenizer in the checkpoint dir; QA turn skipped")

    print(json.dumps({"deltas": deltas, "tol": args.tol}))
    failed = {k: v for k, v in deltas.items() if v > args.tol}
    if failed:
        print(f"FAIL: deltas over tol: {failed}", file=sys.stderr)
        return 1
    print("OK: all deltas within tol")
    return 0


if __name__ == "__main__":
    sys.exit(main())
