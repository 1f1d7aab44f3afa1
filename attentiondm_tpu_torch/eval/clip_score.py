"""CLIP image-text scoring (a copy of `attentiondm_tpu/eval/clip_score.py`, which is
torch and `transformers` already; used by the attention ablation).

Parity with the reference's `compute_clip_score`
(ablation_study_attention_quantization.py:409-493: CLIP ViT-B/32 cosine
between generated images and class-name prompts).  Model weights cannot be
downloaded on a zero-egress machine, so there are two constructors:

- `make_clip_scorer(model_dir)` — canonical: a local HuggingFace CLIP
  checkpoint (config + weights + tokenizer).  Raises with an actionable
  message when absent; callers (the ablation harness) skip the score.
- `make_random_clip_scorer()` — executes the IDENTICAL scoring path
  (image preprocessing, dual-encoder forward, logit-scaled cosine,
  max-over-prompts mean) on a seeded random-init CLIP built from config
  alone.  Like the quality protocol's random-feature KID proxy, scores are
  only comparable WITHIN one run — but the machinery is executed, tested,
  and the canonical weights drop in without code changes.

Both run the model on `device` (None: the package's `default_device()`,
the current CUDA device; `device="cpu"` for the CPU).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import default_device

CIFAR10_PROMPTS = [
    f"a photo of a {c}"
    for c in (
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    )
]


def _byte_encode(texts: Sequence[str], vocab_size: int, bos: int, eos: int,
                 max_len: int):
    """Minimal deterministic text encoding: UTF-8 bytes as token ids.

    The canonical tokenizer needs vocab/merges FILES (egress-blocked); for
    the random-weights path any fixed injective-enough encoding exercises
    the same text-encoder tensor path.  Returns (input_ids, attention_mask)
    as int64 numpy [N, L]."""
    rows = []
    for t in texts:
        ids = [bos] + [2 + (b % (vocab_size - 3)) for b in t.encode("utf-8")]
        ids = ids[: max_len - 1] + [eos]
        rows.append(ids)
    L = max(len(r) for r in rows)
    input_ids = np.zeros((len(rows), L), np.int64)
    mask = np.zeros((len(rows), L), np.int64)
    for i, r in enumerate(rows):
        input_ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return input_ids, mask


def _scorer_from(model, pixel_fn, text_fn, prompts, device):
    """Shared scoring body: images01 NHWC -> mean over images of the max
    over prompts of the image-text cosine similarity, on `device`."""
    import torch

    device = default_device() if device is None else torch.device(device)
    model.to(device)
    input_ids, attention_mask = text_fn(list(prompts))

    def scorer(images01: np.ndarray) -> float:
        imgs = [(np.clip(x, 0, 1) * 255).astype(np.uint8) for x in images01]
        with torch.no_grad():
            out = model(
                input_ids=torch.as_tensor(input_ids, device=device),
                attention_mask=torch.as_tensor(attention_mask, device=device),
                pixel_values=pixel_fn(imgs).to(device),
            )
            # logits_per_image = logit_scale * cosine; undo the scale
            sims = out.logits_per_image / model.logit_scale.exp()
            return float(sims.max(dim=1).values.mean())

    return scorer


def make_clip_scorer(model_dir: str, prompts: Sequence[str] = CIFAR10_PROMPTS, device=None):
    """Returns scorer(images01_nhwc) -> mean max-cosine CLIP score.

    `model_dir` must contain a local `transformers` CLIP checkpoint
    (config + weights + tokenizer); no hub download is attempted.
    """
    try:
        import torch
        from transformers import CLIPModel, CLIPProcessor
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(f"transformers/torch unavailable: {e}") from e

    try:
        model = CLIPModel.from_pretrained(model_dir, local_files_only=True)
        processor = CLIPProcessor.from_pretrained(model_dir, local_files_only=True)
    except Exception as e:
        raise FileNotFoundError(
            f"no local CLIP checkpoint at {model_dir}; CLIP scoring requires "
            f"locally provided weights (zero-egress machine) — or use "
            f"make_random_clip_scorer for within-run comparisons"
        ) from e
    model.eval()

    def pixel_fn(imgs):
        return processor(images=imgs, return_tensors="pt").pixel_values

    def text_fn(texts):
        enc = processor(text=texts, return_tensors="pt", padding=True)
        return enc["input_ids"].numpy(), enc["attention_mask"].numpy()

    return _scorer_from(model, pixel_fn, text_fn, prompts, device)


def make_random_clip_scorer(
    prompts: Sequence[str] = CIFAR10_PROMPTS,
    seed: int = 0,
    config=None,
    device=None,
):
    """Seeded random-init CLIP scorer — no weights, no tokenizer files.

    Built from `transformers.CLIPConfig` alone (default = the ViT-B/32
    geometry the reference scores with); images go through the standard
    `CLIPImageProcessor` resize/normalize, text through a fixed byte
    encoding.  Deterministic in `seed`.  Scores are only meaningful
    RELATIVE to other scores from the same scorer instance/run.
    `config` overrides the model geometry (tests use a tiny one).
    """
    try:
        import torch
        from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(f"transformers/torch unavailable: {e}") from e

    cfg = config or CLIPConfig()
    torch.manual_seed(seed)
    model = CLIPModel(cfg)
    model.eval()
    image_processor = CLIPImageProcessor(
        size={"shortest_edge": cfg.vision_config.image_size},
        crop_size={"height": cfg.vision_config.image_size,
                   "width": cfg.vision_config.image_size},
    )

    def pixel_fn(imgs):
        return image_processor(images=imgs, return_tensors="pt").pixel_values

    tc = cfg.text_config
    bos = tc.bos_token_id if tc.bos_token_id is not None else tc.vocab_size - 2
    eos = tc.eos_token_id if tc.eos_token_id is not None else tc.vocab_size - 1

    def text_fn(texts):
        return _byte_encode(texts, tc.vocab_size, bos, eos,
                            tc.max_position_embeddings)

    return _scorer_from(model, pixel_fn, text_fn, prompts, device)
