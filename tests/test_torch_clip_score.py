"""The port's copy of the CLIP scorer (`eval/clip_score.py`, torch and
`transformers` in both packages): tests/test_clip_score.py's three cases on
the port's copy, and its seeded random scorer equal to JAX's copy's on the
same images.  Skipped without transformers, as test_clip_score.py is."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from attentiondm_tpu.eval import clip_score as jclip  # noqa: E402
from attentiondm_tpu_torch.eval.clip_score import (  # noqa: E402
    CIFAR10_PROMPTS,
    make_clip_scorer,
    make_random_clip_scorer,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return transformers.CLIPConfig(
        text_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "vocab_size": 512, "max_position_embeddings": 32, "bos_token_id": 510, "eos_token_id": 511},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 32, "patch_size": 8},
        projection_dim=16,
    )


def test_random_clip_scorer_runs_and_is_deterministic():
    imgs = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
    s1 = make_random_clip_scorer(seed=3, config=_tiny_cfg(), device="cpu")
    s2 = make_random_clip_scorer(seed=3, config=_tiny_cfg(), device="cpu")
    a, b = s1(imgs), s2(imgs)
    assert np.isfinite(a) and -1.0 <= a <= 1.0  # a cosine
    assert a == b
    assert abs(a - s1(1.0 - imgs)) > 1e-9  # the image tower reads the pixels


def test_random_clip_scorer_prompt_sensitivity():
    imgs = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    full = make_random_clip_scorer(seed=0, config=_tiny_cfg(), device="cpu")(imgs)
    two = make_random_clip_scorer(seed=0, config=_tiny_cfg(), prompts=CIFAR10_PROMPTS[:2], device="cpu")(imgs)
    assert np.isfinite(full) and np.isfinite(two)
    assert full >= two - 1e-6  # max over 10 prompts >= max over 2 of them


def test_pretrained_scorer_missing_dir_raises_actionably(tmp_path):
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        make_clip_scorer(str(tmp_path / "nope"), device="cpu")


def test_random_scorer_equals_jax_copys():
    """The same seed, config and images score the same through either copy."""
    imgs = np.random.default_rng(2).random((3, 32, 32, 3)).astype(np.float32)
    ours = make_random_clip_scorer(seed=5, config=_tiny_cfg(), device="cpu")(imgs)
    theirs = jclip.make_random_clip_scorer(seed=5, config=_tiny_cfg())(imgs)
    assert ours == theirs
    assert CIFAR10_PROMPTS == jclip.CIFAR10_PROMPTS


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the CUDA device here")
def test_scorer_defaults_to_the_card():
    """Without `device=`, the scorer runs on `default_device()`: with no CUDA
    device that raises instead of falling back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_random_clip_scorer(seed=0, config=_tiny_cfg())
