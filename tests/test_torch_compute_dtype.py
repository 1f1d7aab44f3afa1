"""PyTorch port vs the JAX package: `compute_dtype=bfloat16`, the runner's
`--compute_dtype bfloat16`.  The FP `unet_apply` (both attention variants)
and the fake-quant `QuantizedUNet.apply` / `prepare_params` at bf16 against
JAX's, on the toy UNet from the same numpy params and inputs.

At bf16 every conv, dense and residual add rounds to 8 mantissa bits, and
the two stacks sum their float32 products in different orders before that
rounding, so a value near a bf16 tie rounds the other way in one of them and
the difference travels on; the tolerances below are measured, each stated
at its test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.models.unet import cast_params as j_cast_params
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu_torch.models.unet import UNetConfig, cast_params, from_jax_params, unet_apply
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 8, 8, 3)).astype(np.float32), np.array([500.0, 20.0], np.float32)


def _params(variant):
    jcfg = JConfig(**TOY, attn_variant=variant)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    if variant == "enhanced":  # JAX's init sets gamma to 0 (each block the identity)
        rng = np.random.default_rng(3)
        jparams = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(rng.uniform(0.5, 1.0, a.shape), a.dtype) if "gamma" in str(p[-1]) else a,
            jparams)
    return jcfg, jparams


@pytest.mark.parametrize("variant", ["ddim", "enhanced"])
def test_fp_unet_bf16_matches_jax(variant):
    """`unet_apply(compute_dtype=bfloat16)` on `cast_params(params, bf16)`:
    a float32 eps.  Each stack's bf16 forward lies 1.3% (mean relative) from
    its own f32 forward (JAX: 1.36e-2 ddim, 1.42e-2 enhanced; port: 1.26e-2,
    1.26e-2), and the two bf16 forwards lie 1.5e-2 / 1.5e-2 apart, what two
    independent roundings of that size give (the f32 forwards agree to
    2.3e-6).  Held: port vs JAX at bf16 < 3e-2, and the port's bf16 error
    against f32 within 1.25x of JAX's."""
    jcfg, jparams = _params(variant)
    x, t = _inputs(0)
    want = np.asarray(j_unet_apply(j_cast_params(jparams, jnp.bfloat16), jcfg, jnp.asarray(x), jnp.asarray(t),
                                   compute_dtype=jnp.bfloat16))
    want_f32 = np.asarray(j_unet_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t)))
    cfg = dataclasses.replace(UNetConfig(**TOY), attn_variant=variant)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = unet_apply(cast_params(params, torch.bfloat16), cfg, torch.from_numpy(x), torch.from_numpy(t),
                     compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel = _rel(got.numpy(), want)
    assert rel < 3e-2, rel
    got_f32 = unet_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(t))
    assert _rel(got.numpy(), got_f32.numpy()) < 1.25 * _rel(want, want_f32)


def _states(jq, rng, steps):
    """Seeded activation states with a spread of group ranges (mixed by the alpha logits)."""
    out = {}
    for name, st in jq.init_state(steps).items():
        S, G, C = st.alpha_logits.shape
        gr = np.stack([-rng.uniform(0.5, 4, (S, G)), rng.uniform(0.5, 6, (S, G))], -1).astype(np.float32)
        out[name] = dict(init_range=np.asarray(st.init_range), act_min=np.asarray(st.act_min),
                         act_max=np.asarray(st.act_max), group_ranges=gr,
                         alpha_logits=np.asarray(rng.uniform(-1, 1, (S, G, C)), np.float32))
    return out


def test_fake_quant_bf16_matches_jax():
    """`QuantizedUNet.prepare_params(compute_dtype=bf16)` (weights quantized
    in f32, then cast: bit-equal to JAX's) and `apply(compute_dtype=bf16)`
    (each conv's range math in f32, the conv at bf16).  With these seeded
    states the f32 forwards already lie 1.6e-2 apart (activation codes on
    rounding ties, test_torch_qunet_fq.py); each bf16 forward lies 4.2e-2
    (JAX) / 4.3e-2 (port) from its f32 one, and the two bf16 forwards 4.0e-2
    apart.  Held: < 5e-2, test_torch_qunet_fq.py's bound for these forwards,
    and the port's bf16 error against f32 within 1.25x of JAX's."""
    jcfg, jparams = _params("ddim")
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    states = _states(jq, np.random.default_rng(1), 2)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()}) for k, d in states.items()}
    x, t = _inputs(2)
    jqp, _ = jq.prepare_params(jparams, compute_dtype=jnp.bfloat16)
    want = np.asarray(jq.apply(jqp, jqs, jnp.asarray(x), jnp.asarray(t), 1, compute_dtype=jnp.bfloat16))
    want_f32 = np.asarray(jq.apply(jq.prepare_params(jparams)[0], jqs, jnp.asarray(x), jnp.asarray(t), 1))

    cfg = UNetConfig(**TOY)
    q = QuantizedUNet.create(cfg, 4, 8)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    qstates = from_jax_qstates(states, device="cpu")
    qp, _ = q.prepare_params(params, compute_dtype=torch.bfloat16)
    for name in ("conv_in", "down.0.block.0.conv1", "conv_out"):
        node, jnode = qp, jqp
        for part in name.split("."):
            node, jnode = (node[int(part)], jnode[int(part)]) if part.isdigit() else (node[part], jnode[part])
        np.testing.assert_array_equal(node["kernel"].float().numpy(), np.asarray(jnode["kernel"].astype(jnp.float32)),
                                      err_msg=name)
    eps = q.apply(qp, qstates, torch.from_numpy(x), torch.from_numpy(t), 1, compute_dtype=torch.bfloat16)
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), want)
    assert rel < 5e-2, rel
    eps_f32 = q.apply(q.prepare_params(params)[0], qstates, torch.from_numpy(x), torch.from_numpy(t), 1)
    assert _rel(eps.numpy(), eps_f32.numpy()) < 1.25 * _rel(want, want_f32)
