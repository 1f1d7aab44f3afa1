"""PyTorch port vs the JAX package: the weight extras (quant.adaround,
quant.gptq), the fold that consumes them (ops.quant_conv.fold_weights_int8's
`round_offset`, quant.int8_runtime._fold_all_steps, the serving sampler's
`weight_extras`) and the calibration cache (quant.calib_cache).

The JAX side runs once per module on a one-level toy UNet under seeded
random activation states: the Grams, the three methods' extras, one layer's
AdaRound and GPTQ on its Gram, a 2-step serving sampler with extras and
refinements, and a cache file."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.ops import quant_conv as jqc
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import adaround as jar
from attentiondm_tpu.quant import calib_cache as jcache
from attentiondm_tpu.quant.int8_runtime import _fold_all_steps as j_fold_all_steps
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu.quant.state import mixed_ranges
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, conv2d, from_jax_params, lookup
from attentiondm_tpu_torch.ops import quant_conv as qc
from attentiondm_tpu_torch.quant import adaround as ar
from attentiondm_tpu_torch.quant import calib_cache
from attentiondm_tpu_torch.quant import gptq
from attentiondm_tpu_torch.quant.int8_runtime import _fold_all_steps, _step_ranges
from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime, serving_ddim_sampler
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SEQ = [0, 900]
METHODS = {"adaround": dict(iters=20), "gptq": dict(method="gptq"), "biascorr": dict(adaround_max_wbit=0)}
ADA_LAYER = "down.0.block.0.conv1"  # K = 1152
FOLD_LAYERS = ("down.0.block.0.conv1", "up.0.block.0.nin_shortcut")  # a 3x3 and a 1x1 conv
XFIELDS = ("round_offset", "mu", "shrink", "out_mult", "bias_delta")
QFIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _states(jq, S, rng):
    """Seeded activation states: random group ranges, logits constant over the groups (stage 1's)."""
    out = {}
    for name, st in jq.init_state(S).items():
        G, C = st.alpha_logits.shape[1:]
        gr = np.stack([-rng.uniform(0.3, 4, (S, G)), rng.uniform(0.5, 6, (S, G))], -1).astype(np.float32)
        out[name] = dict(init_range=np.asarray(st.init_range), act_min=np.asarray(st.act_min),
                         act_max=np.asarray(st.act_max), group_ranges=gr,
                         alpha_logits=np.full((S, G, C), rng.uniform(-1, 1), np.float32))
    return out


def _refinements(extras, co_of, S, rng):
    """Per-step out_mult / bias_delta [S, co] beside each layer's extras, different at every step."""
    return {n: dict(out_mult=(1.0 + 0.1 * rng.standard_normal((S, co_of[n]))).astype(np.float32),
                    bias_delta=(0.05 * rng.standard_normal((S, co_of[n]))).astype(np.float32)) for n in extras}


def _to_port(jextras, device="cpu"):
    """JAX WeightExtras (numpy leaves or a dict of them) -> the port's (round offsets int16)."""
    out = {}
    for n, ex in jextras.items():
        d = ex if isinstance(ex, dict) else {f: getattr(ex, f) for f in XFIELDS}
        f = {k: None if d.get(k) is None else _t(np.asarray(d[k])).to(device) for k in XFIELDS}
        if f["round_offset"] is not None:
            f["round_offset"] = f["round_offset"].to(torch.int16)
        out[n] = ar.WeightExtras(**f)
    return out


class _Args:
    """The runner's attribute names, as the cache's header reads them."""
    seed, eta, bitwidth, a_bitwidth, weight_opt = 0, 0.0, 4, 8, "gptq"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    rng = np.random.default_rng(0)
    states = _states(jq, len(SEQ), rng)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()}) for k, d in states.items()}
    xs = rng.standard_normal((len(SEQ), 2, 8, 8, 3)).astype(np.float32)
    jstats = jar.collect_conv_stats(jparams, jcfg, jnp.asarray(xs), SEQ, max_steps=2)
    jextras = {m: jar.compute_weight_extras(jq, jparams, jqs, jnp.asarray(xs), SEQ, max_steps=2, **kw)
               for m, kw in METHODS.items()}
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    co_of = {n: lookup(np_params, n)["kernel"].shape[3] for n in jextras["adaround"]}

    # one layer's AdaRound on JAX's Gram at the fold's mean-scale grid
    kernel = lookup(jparams, ADA_LAYER)["kernel"]
    scale = jnp.stack([255.0 / (lambda r: r[1] - r[0])(mixed_ranges(jqs[ADA_LAYER], s)) for s in range(len(SEQ))])
    kh, kw, ci, co = kernel.shape
    g = (kernel / scale.mean(axis=0).reshape(1, 1, ci, 1)).reshape(kh * kw * ci, co)
    gram = jstats[ADA_LAYER].gram / jstats[ADA_LAYER].count
    shrink = jqc.fold_shrink_search(kernel, scale.mean(axis=0), 4, True)
    h = jar._adaround_opt(g, gram, shrink, w_bit=4, symmetric=True, iters=200)
    ada_layer = dict(g=np.asarray(g), gram=np.asarray(gram), shrink=np.asarray(shrink), out=np.asarray(h))

    # the fold with each method's extras and per-step refinements, per-step and rank-1
    refine = _refinements(jextras["adaround"], co_of, len(SEQ), rng)
    folds = {}
    for m, ex in jextras.items():
        for rank1 in (False, True):
            for name in FOLD_LAYERS:
                e, r = ex[name], refine[name]
                kw = dict(round_offset=e.round_offset, input_mu=e.mu, shrink=e.shrink,
                          out_mult=jnp.asarray(r["out_mult"][0] if rank1 else r["out_mult"]),
                          bias_delta=jnp.asarray(r["bias_delta"][0] if rank1 else r["bias_delta"]))
                folds[m, rank1, name] = [np.asarray(a) for a in j_fold_all_steps(
                    lookup(jparams, name)["kernel"], jqs[name].group_ranges, jqs[name].alpha_logits, 8, 4, True,
                    rank1=rank1, **kw)]

    # the serving sampler with AdaRound's extras and the per-step refinements: all five fields
    jx_ref = {n: jar.WeightExtras(round_offset=e.round_offset, mu=e.mu, shrink=e.shrink,
                                  out_mult=jnp.asarray(refine[n]["out_mult"]),
                                  bias_delta=jnp.asarray(refine[n]["bias_delta"]))
              for n, e in jextras["adaround"].items()}
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    sample = j_sampler(jq, jparams, jqs, SEQ, betas, residual_dtype=jnp.bfloat16, attn_int8=False,
                       weight_extras=jx_ref)(jnp.asarray(x))

    cache = str(tmp_path_factory.mktemp("cache") / "jax.npz")
    attn = {"mid.attn_1.q": np.linspace(1, 2, len(SEQ)).astype(np.float32)}
    jcache.save_calibration(cache, _Args(), SEQ, jqs, attn_ranges=attn, weight_extras=jextras["gptq"],
                            sample_count=np.arange(len(SEQ), dtype=np.float32), timestep_select=1)

    def np_extras(ex):
        return {n: {f: None if getattr(e, f) is None else np.asarray(getattr(e, f)) for f in XFIELDS}
                for n, e in ex.items()}

    return dict(
        params=from_jax_params(np_params, device="cpu"), np_params=np_params, states=states,
        qstates=from_jax_qstates(states, device="cpu"), xs=xs, x=x, co_of=co_of,
        stats={n: (np.asarray(s.gram), np.asarray(s.mu), float(s.count)) for n, s in jstats.items()},
        extras={m: np_extras(e) for m, e in jextras.items()}, ada_layer=ada_layer, folds=folds, refine=refine,
        sample=np.asarray(sample), cache=cache, attn=attn,
    )


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8)


# --- Gram collection ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("ksize", [1, 3])
def test_im2col_matches_jax_and_the_conv(ksize):
    """Patches in (dy, dx, c) order, JAX's bit for bit; patches @ the
    flattened HWIO kernel is the SAME conv."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize, 5, 7)).astype(np.float32)
    pat = ar._im2col(_t(x), ksize)
    np.testing.assert_array_equal(pat.numpy(), np.asarray(jar._im2col(jnp.asarray(x), ksize)))
    got = (pat @ _t(w).reshape(-1, 7)).reshape(2, 6, 6, 7)
    want = conv2d(_t(x), {"kernel": _t(w), "bias": torch.zeros(7)})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_grams_match_jax(chain):
    """The port's own float forward and Grams against JAX's: every eligible
    and ineligible conv, sums within float order (measured: at most 7.5e-7
    of the Gram's largest entry), counts equal."""
    cfg, _q = _port()
    stats = ar.collect_conv_stats(chain["params"], cfg, _t(chain["xs"]), SEQ, max_steps=2)
    assert stats.keys() == chain["stats"].keys()
    for name, (gram, mu, count) in chain["stats"].items():
        st = stats[name]
        assert float(st.count) == count == 2 * 2 * 8 * 8, name
        assert st.gram.shape == gram.shape, name
        np.testing.assert_allclose(st.gram.numpy(), gram, rtol=0, atol=1e-5 * np.abs(gram).max(), err_msg=name)
        np.testing.assert_allclose(st.mu.numpy(), mu, rtol=0, atol=1e-5 * np.abs(mu).max(), err_msg=name)
        g = st.gram.numpy().astype(np.float64)
        ev = np.linalg.eigvalsh((g + g.T) / 2)
        assert ev.min() > -1e-2 * max(1.0, ev.max()), name  # positive semi-definite up to rounding


def test_pack_gram_chunks_matches_jax():
    k_of = {"a": 6000, "b": 18432, "c": 6000, "d": 500}
    for names, budget in ((["a", "b", "c"], 1 << 30), (["d", "a", "c", "b"], 2 * 4 * 6000 ** 2), (["d"], 1)):
        got = ar._pack_gram_chunks(names, k_of, budget)
        assert got == jar._pack_gram_chunks(names, k_of, budget)
        assert [n for ch in got for n in ch] == names
    assert ["b"] in ar._pack_gram_chunks(["a", "b", "c"], k_of, 1 << 30)  # over the budget alone: its own pass


def test_large_k_chunked_collection_matches_joint(chain, monkeypatch):
    """Layers over GRAM_K_CAP ride extra passes of at most `chunk_bytes` of
    Gram each and land the same Grams and GPTQ decisions as the joint
    collection (GRAM_K_CAP shrunk so every 3x3 conv, K = 1152, takes that
    path, two Grams a pass)."""
    cfg, q = _port()
    args = (q, chain["params"], chain["qstates"], _t(chain["xs"]), SEQ)
    ref_stats = ar.collect_weight_stats(*args, max_steps=2)
    ref = ar.compute_weight_extras(*args, max_steps=2, method="gptq", stats=ref_stats)
    monkeypatch.setattr(ar, "GRAM_K_CAP", 500)
    passes = []
    collect = ar.collect_conv_stats
    monkeypatch.setattr(ar, "collect_conv_stats", lambda *a, **kw: passes.append(kw["names"]) or collect(*a, **kw))
    stats = ar.collect_weight_stats(*args, max_steps=2, chunk_bytes=2 * 4 * 1152 ** 2)
    got = ar.compute_weight_extras(*args, max_steps=2, method="gptq", stats=stats)
    assert len(passes) > 2 and all(len(p) <= 2 for p in passes[1:])
    big = [n for n in ref if ref[n].round_offset is not None and ref[n].round_offset.shape[0] == 3]
    assert big and set(got) == set(ref)
    for n in big:
        assert torch.equal(stats[n].gram, ref_stats[n].gram), n
        assert torch.equal(got[n].round_offset, ref[n].round_offset), n
        assert torch.equal(got[n].mu, ref[n].mu), n


def test_k_max_fallback_warns_and_keeps_mu(chain, monkeypatch, caplog):
    """A layer over `k_max` keeps round-to-nearest, says so, and still gets
    its mean for the bias correction."""
    _cfg, q = _port()
    monkeypatch.setattr(ar, "GRAM_K_CAP", 500)
    with caplog.at_level(logging.WARNING):
        got = ar.compute_weight_extras(q, chain["params"], chain["qstates"], _t(chain["xs"]), SEQ, max_steps=2,
                                       method="gptq", k_max=500)
    assert any("exceeds k_max" in r.message for r in caplog.records)
    big = [n for n in got if got[n].mu.shape[0] == 9 * 128]
    assert big and all(got[n].round_offset is None for n in big)
    assert any(got[n].round_offset is not None for n in got if got[n].mu.shape[0] <= 500)


# --- the optimizers on JAX's Gram -----------------------------------------------------------------------------


def _objective(layer, q, w_bit=4):
    """sum_n d_n^T H d_n of integer grid values q on the layer's grid (float64)."""
    g = layer["g"].astype(np.float64)
    n = 2 ** (w_bit - 1)
    ws = (n - 1) / (np.maximum(np.abs(layer["g"]).max(axis=0), 1e-8) * layer["shrink"]).astype(np.float64)
    d = np.clip(q, -n, n - 1) / ws - g
    return float(np.sum(d * (layer["gram"].astype(np.float64) @ d)))


def test_adaround_matches_jax_on_its_gram(chain):
    """Given JAX's Gram, 200 Adam steps: decisions equal on at least 99.5%
    of the weights (measured 100%: torch.optim.Adam and optax round apart,
    so a weight whose h ends near 0.5 can flip), the Gram objective within 1%
    of JAX's and at most round-to-nearest's x 1.0001."""
    layer = chain["ada_layer"]
    h = ar._adaround_opt(_t(layer["g"]), _t(layer["gram"]), _t(layer["shrink"]), w_bit=4, symmetric=True, iters=200)
    assert set(np.unique(h.numpy())) <= {0.0, 1.0}
    assert (h.numpy() == layer["out"]).mean() >= 0.995
    n = 8
    ws = (n - 1) / (np.maximum(np.abs(layer["g"]).max(axis=0), 1e-8) * layer["shrink"])
    base = ws * layer["g"]
    e_port, e_jax = _objective(layer, np.floor(base) + h.numpy()), _objective(layer, np.floor(base) + layer["out"])
    e_rtn = _objective(layer, np.round(base))
    assert abs(e_port - e_jax) <= 0.01 * e_jax, (e_port, e_jax)
    assert e_port <= e_rtn * 1.0001, (e_port, e_rtn)


def _stats(chain):
    return {n: ar.ConvStats(gram=_t(g), mu=_t(m), count=torch.tensor(c)) for n, (g, m, c) in chain["stats"].items()}


def _objectives(chain, extras, stats, offsets_of):
    """{layer: (objective of `extras`' offsets, of offsets_of(layer), of round-to-nearest)} on `stats`' Grams."""
    _cfg, q = _port()
    out = {}
    for n, ex in extras.items():
        kernel = _t(lookup(chain["np_params"], n)["kernel"])
        st = chain["qstates"][n]
        scale = _step_ranges(st.group_ranges, st.alpha_logits, 8)[0].mean(dim=0)
        w_bit = q.policy[n].w_bit
        out[n] = [float(ar.gram_objective(kernel, scale, stats[n], w_bit, ex.shrink, offs))
                  for offs in (ex.round_offset, offsets_of(n), None)]
    return out


def test_gptq_matches_jax_on_its_gram(chain):
    """Given JAX's Grams, every layer: grid values equal on at least 99% of
    the model's weights (measured 99.43%, each layer at least 98.8%:
    torch.linalg's and jnp.linalg's Cholesky factors of these Grams, whose
    condition number reaches 4e4, differ by 1.3e-4 relative, each as far
    from the float64 factor, so a column can round the other way and the
    compensation carries it on), each layer's output-space objective within
    1% of JAX's and below round-to-nearest's."""
    _cfg, q = _port()
    stats = _stats(chain)
    got = ar.compute_weight_extras(q, chain["params"], chain["qstates"], _t(chain["xs"]), SEQ, method="gptq",
                                   stats=stats)
    want = chain["extras"]["gptq"]
    equal = sum(int((ex.round_offset.numpy() == want[n]["round_offset"]).sum()) for n, ex in got.items())
    assert equal >= 0.99 * sum(ex.round_offset.numel() for ex in got.values())
    for n, (e_port, e_jax, e_rtn) in _objectives(chain, got, stats, lambda n: _t(want[n]["round_offset"])).items():
        assert abs(e_port - e_jax) <= 0.01 * e_jax, (n, e_port, e_jax)
        assert e_port < e_rtn or e_port == e_rtn == 0.0, (n, e_port, e_rtn)


def test_gptq_blocked_equals_unblocked():
    """Lazy blocked compensation (block 16 of K = 100, so the padded path
    runs) makes the decisions of one block of K, as JAX's
    tests/test_gptq.py holds."""
    rng = np.random.default_rng(5)
    K, co, m = 100, 12, 2048
    x = rng.standard_normal((m, 6)) @ rng.standard_normal((6, K)) + 0.05 * rng.standard_normal((m, K))
    H = _t((x.T @ x / m).astype(np.float32))
    g = _t(rng.standard_normal((K, co)).astype(np.float32))
    ref = gptq._gptq_opt(g, H, torch.ones(co), w_bit=4, symmetric=True, block=K)
    assert torch.equal(gptq._gptq_opt(g, H, torch.ones(co), w_bit=4, symmetric=True, block=16), ref)


def test_gptq_with_identity_hessian_is_round_to_nearest():
    g = torch.randn(32, 8, generator=torch.Generator().manual_seed(0))
    gq = gptq._gptq_opt(g, torch.eye(32), torch.ones(8), w_bit=4, symmetric=True, act_order=False)
    ws = 7 / g.abs().amax(dim=0)
    assert torch.equal(gq, torch.clamp(torch.round(ws * g), -8, 7))


def test_stacked_layers_solve_each_layer_alone(chain):
    """A stack of layers of one shape (as `compute_weight_extras` runs them)
    gives each layer its own decisions: the stack's rows equal the layers
    run alone."""
    layer = chain["ada_layer"]
    g, gram, shrink = _t(layer["g"]), _t(layer["gram"]), _t(layer["shrink"])
    g2 = g * 1.5
    for opt, kw in ((ar._adaround_opt, dict(iters=10)), (gptq._gptq_opt, {})):
        both = opt(torch.stack([g, g2]), torch.stack([gram, gram]), torch.stack([shrink, shrink]), w_bit=4,
                   symmetric=True, **kw)
        for i, gi in enumerate((g, g2)):
            alone = opt(gi, gram, shrink, w_bit=4, symmetric=True, **kw)
            assert (both[i] == alone).float().mean() >= 0.999, opt  # bmm and mm may round a sum apart


def test_per_layer_offsets(chain):
    """`adaround_offsets` / `gptq_offsets` (one layer, JAX's signatures):
    int16 [kh, kw, ci, co], the optimizers' decisions on the layer's
    normalized Gram at its mean-scale grid; None without a Gram."""
    layer = chain["ada_layer"]
    kernel = _t(lookup(chain["np_params"], ADA_LAYER)["kernel"])
    st = chain["qstates"][ADA_LAYER]
    scale = _step_ranges(st.group_ranges, st.alpha_logits, 8)[0].mean(dim=0)
    gram, mu, count = chain["stats"][ADA_LAYER]
    stats = ar.ConvStats(gram=_t(gram), mu=_t(mu), count=torch.tensor(count))
    g, gn, sh = _t(layer["g"]), _t(layer["gram"]), _t(layer["shrink"])
    got = ar.adaround_offsets(kernel, scale, stats, 4, shrink=sh, iters=20)
    assert got.dtype == torch.int16 and tuple(got.shape) == tuple(kernel.shape)
    want = ar._adaround_opt(g, gn, sh, w_bit=4, symmetric=True, iters=20)
    assert (got.reshape(g.shape).float() == want).float().mean() >= 0.999  # g, Gram from the port's f32 ops
    got = gptq.gptq_offsets(kernel, scale, stats, 4, shrink=sh)
    want = gptq._offsets_of(gptq._gptq_opt(g[None], gn[None], sh[None], w_bit=4, symmetric=True), g[None], sh[None], 4,
                            True)[0]
    assert got.dtype == torch.int16 and (got.reshape(g.shape).float() == want).float().mean() >= 0.99
    placeholder = ar.ConvStats(gram=torch.zeros(1, 1), mu=_t(mu), count=torch.tensor(count))
    assert ar.adaround_offsets(kernel, scale, placeholder, 4) is None
    assert gptq.gptq_offsets(kernel, scale, placeholder, 4) is None


@pytest.mark.parametrize("method", list(METHODS))
def test_compute_weight_extras_matches_jax(chain, method):
    """From the port's own Grams: the same layers, the same pinned shrinks,
    the means within float order, the offsets int16 and equal to JAX's on at
    least 99.5% of each layer's weights (AdaRound) / 99% of the model's
    (GPTQ); bias correction alone has none."""
    _cfg, q = _port()
    got = ar.compute_weight_extras(q, chain["params"], chain["qstates"], _t(chain["xs"]), SEQ, max_steps=2,
                                   **METHODS[method])
    want = chain["extras"][method]
    assert got.keys() == want.keys()
    for n, ex in got.items():
        np.testing.assert_array_equal(ex.shrink.numpy(), want[n]["shrink"], err_msg=n)
        np.testing.assert_allclose(ex.mu.numpy(), want[n]["mu"], rtol=0, atol=1e-5 * np.abs(want[n]["mu"]).max())
        if method == "biascorr":
            assert ex.round_offset is None and want[n]["round_offset"] is None
            continue
        assert ex.round_offset.dtype == torch.int16 and ex.round_offset.shape == want[n]["round_offset"].shape
        agree = (ex.round_offset.numpy() == want[n]["round_offset"]).mean()
        assert method == "gptq" or agree >= 0.995, (n, agree)
    if method == "gptq":  # offsets signed and several levels; equal on 99% of the weights (measured 99.26%)
        offs = torch.cat([ex.round_offset.flatten() for ex in got.values()])
        assert offs.min() < 0 and offs.max() > 1
        want_offs = np.concatenate([want[n]["round_offset"].ravel() for n in got])
        assert (offs.numpy() == want_offs).mean() >= 0.99


# --- the fold -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("rank1", [False, True], ids=["per_step", "rank1"])
@pytest.mark.parametrize("method", list(METHODS))
def test_fold_with_extras_matches_jax(chain, method, rank1):
    """`_fold_all_steps` with JAX's extras of each method and the
    refinements ([S, co] per step, or [co] with rank1): gq bit-equal, and
    per step ws, act_scale and act_zp too (rank-1: ws and the scales to f32
    rounding, as the plain rank-1 fold); zcorr, whose bias-correction term
    mu @ (g - g_hat) sums in another order, within the plain fold's bound."""
    extras = _to_port({n: chain["extras"][method][n] for n in FOLD_LAYERS})
    for name in FOLD_LAYERS:
        r = chain["refine"][name]
        ex = extras[name]
        st = chain["qstates"][name]
        got = _fold_all_steps(_t(lookup(chain["np_params"], name)["kernel"]), st.group_ranges, st.alpha_logits, 8, 4,
                              rank1=rank1, round_offset=ex.round_offset, input_mu=ex.mu, shrink=ex.shrink,
                              out_mult=_t(r["out_mult"][0] if rank1 else r["out_mult"]),
                              bias_delta=_t(r["bias_delta"][0] if rank1 else r["bias_delta"]))
        gq, ws, wzp, zc, scale, zp = chain["folds"][method, rank1, name]
        np.testing.assert_array_equal(got[0].numpy(), gq, err_msg=name)
        np.testing.assert_array_equal(got[2].numpy(), wzp, err_msg=name)
        np.testing.assert_array_equal(got[5].numpy(), zp, err_msg=name)
        if rank1:
            np.testing.assert_allclose(got[1].numpy(), ws, rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(got[4].numpy(), scale, rtol=2e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got[1].numpy(), ws, err_msg=name)
            np.testing.assert_array_equal(got[4].numpy(), scale, err_msg=name)
        np.testing.assert_allclose(got[3].numpy(), zc, rtol=1e-5, atol=1e-5 * np.abs(zc).max(), err_msg=name)


def test_nearest_round_offsets_reproduce_the_plain_fold():
    """Offsets that encode round-to-nearest give the plain fold bit for bit."""
    g = torch.Generator().manual_seed(5)
    kernel = torch.randn((3, 3, 128, 128), generator=g) * 0.2
    act_scale = torch.randn(128, generator=g).abs() + 0.5
    g = kernel / act_scale.reshape(1, 1, -1, 1)
    base = qc.weight_grid(g, 4, True)[0] * g
    offs = (torch.round(base) - torch.floor(base)).to(torch.int16)
    plain = qc.fold_weights_int8(kernel, act_scale, 4, symmetric=True)
    with_offs = qc.fold_weights_int8(kernel, act_scale, 4, symmetric=True, round_offset=offs)
    for a, b in zip(plain, with_offs):
        assert torch.equal(a, b)


def test_empty_extras_are_no_extras(chain):
    """`{}` is no extras (falsy, as in JAX): the plain fold."""
    _cfg, q = _port()
    a = prepare_serving_runtime(q, chain["params"], chain["qstates"])
    b = prepare_serving_runtime(q, chain["params"], chain["qstates"], weight_extras={})
    for n in a:
        assert torch.equal(a[n].gqt, b[n].gqt) and torch.equal(a[n].zcbias, b[n].zcbias), n


# --- the serving sampler --------------------------------------------------------------------------------------


def _extras_with_refinements(chain, method):
    ex = _to_port(chain["extras"][method])
    for n, e in ex.items():
        e.out_mult = _t(chain["refine"][n]["out_mult"])
        e.bias_delta = _t(chain["refine"][n]["bias_delta"])
    return ex


def test_serving_sampler_with_extras_matches_jax(chain):
    """The 2-step serving sampler with AdaRound's offsets, means and shrinks
    and per-step refinements (all five fields) against JAX's sampler with the
    same extras: within the toy bound of the plain sampler's test (1e-2;
    the port's fold differs from JAX's in zcbias's last bits)."""
    _cfg, q = _port()
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16,
                               attn_int8=False, weight_extras=_extras_with_refinements(chain, "adaround"))(
        _t(chain["x"]))
    assert torch.isfinite(out).all()
    assert _rel(out.numpy(), chain["sample"]) < 1e-2


@pytest.mark.parametrize("method", list(METHODS))
def test_sampler_takes_every_method_per_step_rank1_and_chunked(chain, method):
    """Each method's extras with the per-step refinements: 4 steps chunked
    by 3 are bit-equal to the unchunked sampler (each chunk folds its rows
    of the [S, co] fields; JAX's test_chunked_sampler_slices_per_step_extras);
    the rank-1 sampler takes the extras too (finite, near the per-step
    fold's sample)."""
    _cfg, q = _port()
    jq = JQuantizedUNet.create(JConfig(**TOY), bitwidth=4, a_bitwidth=8)
    seq = [0, 300, 600, 900]
    qstates = from_jax_qstates(_states(jq, len(seq), np.random.default_rng(7)), device="cpu")
    rng = np.random.default_rng(8)
    ex = _to_port(chain["extras"][method])
    for n, e in ex.items():
        r = _refinements([n], chain["co_of"], len(seq), rng)[n]
        e.out_mult, e.bias_delta = _t(r["out_mult"]), _t(r["bias_delta"])
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(3))
    kw = dict(residual_dtype=torch.bfloat16, attn_int8=False, weight_extras=ex)
    full = serving_ddim_sampler(q, chain["params"], qstates, seq, betas, **kw)(x)
    assert torch.equal(serving_ddim_sampler(q, chain["params"], qstates, seq, betas, step_chunk=3, **kw)(x), full)
    shared = {n: ar.WeightExtras(e.round_offset, e.mu, e.shrink, e.out_mult[0], e.bias_delta[0])
              for n, e in ex.items()}
    r1 = serving_ddim_sampler(q, chain["params"], qstates, seq, betas, rank1=True,
                              **{**kw, "weight_extras": shared})(x)
    assert torch.isfinite(r1).all() and _rel(r1.numpy(), full.numpy()) < 0.5


# --- the calibration cache ------------------------------------------------------------------------------------


def test_jax_cache_loads_in_the_port(chain):
    """Format 3 written by JAX: the same arrays in the port, round offsets
    int16 with their negative values."""
    got = calib_cache.load_calibration(chain["cache"], _Args(), SEQ, device="cpu")
    assert got is not None and got["timestep_select"] == 1
    np.testing.assert_array_equal(got["sample_count"].numpy(), np.arange(len(SEQ), dtype=np.float32))
    np.testing.assert_array_equal(got["attn_ranges"]["mid.attn_1.q"].numpy(), chain["attn"]["mid.attn_1.q"])
    assert got["qstates"].keys() == chain["states"].keys()
    for n, st in got["qstates"].items():
        for f in QFIELDS:
            np.testing.assert_array_equal(getattr(st, f).numpy(), chain["states"][n][f], err_msg=f"{n}.{f}")
    want = chain["extras"]["gptq"]
    assert got["weight_extras"].keys() == want.keys()
    for n, ex in got["weight_extras"].items():
        assert ex.round_offset.dtype == torch.int16 and ex.out_mult is None
        for f in ("round_offset", "mu", "shrink"):
            np.testing.assert_array_equal(getattr(ex, f).numpy(), want[n][f], err_msg=f"{n}.{f}")
    assert min(int(ex.round_offset.min()) for ex in got["weight_extras"].values()) < 0


def test_port_cache_loads_in_jax(chain, tmp_path):
    """The port writes, JAX reads: the same arrays (offsets back as JAX's
    float32), the per-step refinements too; a header that does not match
    the requesting run is ignored by both."""
    path = str(tmp_path / "port.npz")
    extras = _extras_with_refinements(chain, "gptq")
    calib_cache.save_calibration(path, _Args(), SEQ, chain["qstates"], weight_extras=extras)
    got = jcache.load_calibration(path, _Args(), SEQ)
    assert got is not None and got["attn_ranges"] is None and got["sample_count"] is None
    for n, st in got["qstates"].items():
        for f in QFIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)), chain["states"][n][f], err_msg=f"{n}.{f}")
    for n, ex in got["weight_extras"].items():
        for f in XFIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(ex, f)), getattr(extras[n], f).numpy(),
                                          err_msg=f"{n}.{f}")
    back = calib_cache.load_calibration(path, _Args(), SEQ, device="cpu")
    assert all(torch.equal(back["weight_extras"][n].bias_delta, e.bias_delta) for n, e in extras.items())

    class Other(_Args):
        weight_opt = "adaround"

    assert calib_cache.load_calibration(path, Other(), SEQ, device="cpu") is None
    assert jcache.load_calibration(path, Other(), SEQ) is None
    assert calib_cache.load_calibration(str(tmp_path / "missing.npz"), _Args(), SEQ, device="cpu") is None
