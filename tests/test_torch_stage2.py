"""PyTorch port vs the JAX package: stage-2 calibration and the calibration
set (attentiondm_tpu_torch.quant.calibrate: `calibrate_ranges(assignment_init=)`,
`calibrate_differentiable`, `calibrate_teacher_matched`, `alpha_uncertainty`,
`select_calibration_images`), on JAX's enhanced toy UNet at W4A8 with `gamma`
set to 1 in the numpy tree both stacks load.

The JAX side runs once per module: the teacher trajectory and its eps,
stage 1 (each conv's input recorded, with and without the assignment init),
each stage-2 loss and its gradient at one step (JAX's loss functions rebuilt
from its public pieces, as `calibrate.py` composes them), and three whole
stage-2 runs.  Each optimizer is held to optax's on the same gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import adaround as jar
from attentiondm_tpu.quant import calibrate as jcal
from attentiondm_tpu.quant.int8_runtime import _eligible as j_eligible
from attentiondm_tpu.quant.qunet import make_quant_conv_apply as j_make_quant_conv_apply
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, lookup
from attentiondm_tpu_torch.quant import adaround as ar
from attentiondm_tpu_torch.quant import calibrate as cal
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet, make_quant_conv_apply
from attentiondm_tpu_torch.quant.state import from_jax_qstates, mixed_ranges


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0,
           attn_variant="enhanced")
SEQ = [0, 500]
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")
XFIELDS = ("round_offset", "mu", "shrink", "out_mult", "bias_delta")
TM_LR, TM_EPOCHS = 0.02, 2  # the runner's stage-2 lr; two passes over the trajectory
# the teacher-matched variants: which parameters train, on which layers, through which forward
VARIANTS = {"alpha": dict(train_range_scale=False), "rho": dict(train_alpha=False), "both": {},
            "attention_focus": dict(attention_focus=True), "serving_extras": dict(extras=True)}
# `_grad_err` of each teacher-forced gradient: at most 4x the figure measured (alpha / rho on every layer 3.12e-5 /
# 1.41e-5, on the attention projections 1.81e-6 / 9.27e-7, through the surrogate 7.16e-7 / 5.24e-7)
TM_GRAD_BOUND = {("alpha", "alpha"): 1.24e-4, ("rho", "rho"): 5.6e-5, ("both", "alpha"): 1.24e-4, ("both", "rho"): 5.6e-5,
                 ("attention_focus", "alpha"): 7.2e-6, ("attention_focus", "rho"): 3.7e-6,
                 ("serving_extras", "alpha"): 2.8e-6, ("serving_extras", "rho"): 2.0e-6}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _gamma_1(tree):
    if isinstance(tree, dict):
        return {k: np.ones_like(v) if k == "gamma" else _gamma_1(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gamma_1(v) for v in tree]
    return tree


def _is_attn(name):
    return ".attn" in name or name.startswith("mid.attn")


def _np_states(qs):
    return {k: {f: np.asarray(getattr(v, f)) for f in FIELDS} for k, v in qs.items()}


def _np_extras(ex):
    return {n: {f: None if getattr(e, f) is None else np.asarray(getattr(e, f)) for f in XFIELDS}
            for n, e in ex.items()}


def _to_port(np_extras):
    out = {}
    for n, d in np_extras.items():
        f = {k: None if d[k] is None else _t(d[k]) for k in XFIELDS}
        if f["round_offset"] is not None:
            f["round_offset"] = f["round_offset"].to(torch.int16)
        out[n] = ar.WeightExtras(**f)
    return out


def _j_apply_theta(qs, theta):
    """JAX's `calibrate_teacher_matched.apply_theta`, on the layers theta names."""
    out = dict(qs)
    names = set(theta.get("alpha", {})) | set(theta.get("rho", {}))
    for n in names:
        st = out[n]
        gr = st.group_ranges
        if "rho" in theta:
            gr = gr * jnp.exp(theta["rho"][n])[:, None, None]
        out[n] = dataclasses.replace(st, group_ranges=gr,
                                     alpha_logits=theta["alpha"][n] if "alpha" in theta else st.alpha_logits)
    return out


@pytest.fixture(scope="module")
def chain():
    jcfg = JConfig(**TOY)
    np_params = _gamma_1(jax.tree_util.tree_map(np.asarray, j_unet_init(jax.random.PRNGKey(0), jcfg)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x0), SEQ, betas,
                               keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x0)[None], traj[:-1]], axis=0)
    t_rev = np.asarray(SEQ, np.float32)[::-1]
    eps_ref = jnp.stack([j_unet_apply(jparams, jcfg, xs_in[s], jnp.full((2,), t_rev[s])) for s in range(len(SEQ))])
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs0 = jq.init_state(len(SEQ))
    jqs = jcal.calibrate_ranges(jq, jparams, jqs0, xs_in, SEQ, first=True)

    # stage 1 with the assignment init: each conv's input in JAX's calibration forward and JAX's update
    records = []
    one_conv = jax.jit(jcal._calibrate_one_conv, static_argnums=(2, 3, 4, 5))
    for s in range(len(SEQ)):
        def conv_apply(name, xin, p, *, stride=1, padding="SAME", s=s):
            upd, xq = one_conv(xin, jqs0[name], jq.policy[name], s, True, True)
            records.append((s, name, np.asarray(xin), {k: np.asarray(v) for k, v in upd.items()}))
            return jcal.conv2d(xq, p, stride=stride, padding=padding)

        j_unet_apply(jparams, jcfg, xs_in[s], jnp.full((2,), t_rev[s]), conv_apply=conv_apply)

    # the serving extras, seeded: a pinned shrink on every folded conv, {0, 1} offsets on the conv1 layers (the
    # floor branch) and bias-correction means on the conv2 layers
    extras = {}
    for n in jqs:
        shape = jparams_kernel(jparams, n).shape
        if not j_eligible(shape):
            continue
        kh, kw, ci, co = shape
        extras[n] = jar.WeightExtras(
            round_offset=jnp.asarray(rng.integers(0, 2, shape).astype(np.float32)) if n.endswith("conv1") else None,
            mu=jnp.asarray(rng.normal(0, 0.1, kh * kw * ci).astype(np.float32)) if n.endswith("conv2") else None,
            shrink=jnp.asarray(rng.uniform(0.85, 1.0, co).astype(np.float32)))
    jqp, _ = jq.prepare_params(jparams)

    # the losses at step 1 and their gradients: JAX's loss functions rebuilt from its pieces, every conv's output
    # offset by a zero probe whose gradient is the cotangent reaching that conv, and every conv's input recorded
    s1, t1 = 1, jnp.full((2,), t_rev[1], jnp.float32)
    shapes = {}
    j_unet_apply(jparams, jcfg, xs_in[s1], t1, conv_apply=lambda name, xin, p, **kw: shapes.setdefault(
        name, jcal.conv2d(xin, p, **kw)))
    probes = {n: jnp.zeros(o.shape, jnp.float32) for n, o in shapes.items()}

    def probed(ca, pr, rec):
        def conv_apply(name, xin, p, *, stride=1, padding="SAME"):
            rec[name] = xin
            return ca(name, xin, p, stride=stride, padding=padding) + pr[name]

        return conv_apply

    def tm_loss(th, pr, use_extras):
        qs, rec = _j_apply_theta(jqs, th), {}
        if use_extras:
            forward = jcal.unet_apply
            jcal.unet_apply = lambda p, cfg, x, t, *, conv_apply: forward(p, cfg, x, t, conv_apply=probed(
                conv_apply, pr, rec))
            try:
                et = jcal.serving_surrogate_apply(jq, jparams, qs, extras, xs_in[s1], t1, s1)
            finally:
                jcal.unet_apply = forward
        else:
            et = j_unet_apply(jqp, jcfg, xs_in[s1], t1, conv_apply=probed(
                j_make_quant_conv_apply(qs, jq.policy, s1, mode="infer"), pr, rec))
        return jnp.mean(jnp.square(et - eps_ref[s1])) / jnp.mean(jnp.square(eps_ref[s1])), rec

    theta = {"alpha": {n: jqs[n].alpha_logits for n in jqs},
             "rho": {n: jnp.asarray(rng.uniform(-0.2, 0.2, len(SEQ)).astype(np.float32)) for n in jqs}}
    tm = {use: jax.jit(jax.value_and_grad(tm_loss, argnums=(0, 1), has_aux=True), static_argnums=2)(
        theta, probes, use) for use in (False, True)}

    abar = jnp.cumprod(1.0 - betas)
    e1 = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    alphas = {n: jqs[n].alpha_logits + jnp.asarray(rng.normal(0, 0.3, jqs[n].alpha_logits.shape), jnp.float32)
              for n in jqs}

    def diff_loss(al, pr):
        qs, rec = {n: dataclasses.replace(st, alpha_logits=al[n]) for n, st in jqs.items()}, {}
        a = abar[int(t_rev[s1])]
        x_noised = xs_in[s1] * jnp.sqrt(a) + jnp.asarray(e1) * jnp.sqrt(1.0 - a)
        et = j_unet_apply(jparams, jcfg, x_noised, t1, conv_apply=probed(
            j_make_quant_conv_apply(qs, jq.policy, s1, mode="mixture"), pr, rec))
        ent = 0.0
        for n in al:
            ent = ent + jcal._alpha_entropy(al[n][s1], al[n].shape[1], al[n].shape[2])
        return jnp.square(jnp.asarray(e1) - et).sum(axis=(1, 2, 3)).mean() + ent, rec

    diff = jax.jit(jax.value_and_grad(diff_loss, argnums=(0, 1), has_aux=True))(alphas, probes)

    # whole runs: stage 2 (attention_focus, one epoch, JAX's own draws), teacher-matched on the fake-quant model
    # (alpha and rho everywhere) and through the surrogate (attention projections)
    key = jax.random.PRNGKey(5)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (2, 8, 8, 3), jnp.float32))
                      for i in range(len(SEQ))])[None]
    run_diff = jcal.calibrate_differentiable(jq, jparams, jqs, jnp.asarray(x0), SEQ, betas, key=key,
                                             attention_focus=True)
    run_tm = jcal.calibrate_teacher_matched(jq, jqp, jqs, xs_in, eps_ref, SEQ, lr=TM_LR, epochs=TM_EPOCHS)
    run_sur = jcal.calibrate_teacher_matched(jq, jparams, jqs, xs_in, eps_ref, SEQ, lr=TM_LR, epochs=TM_EPOCHS,
                                             attention_focus=True, serving_extras=extras)
    return dict(
        np_params=np_params, params=from_jax_params(np_params, device="cpu"),
        qparams=from_jax_params(jax.tree_util.tree_map(np.asarray, jqp), device="cpu"),
        qstates=from_jax_qstates(_np_states(jqs), device="cpu"), np_states=_np_states(jqs),
        qstates0=from_jax_qstates(_np_states(jqs0), device="cpu"), records=records,
        x0=x0, xs_in=np.asarray(xs_in), eps_ref=np.asarray(eps_ref), t_rev=t_rev, extras=_np_extras(extras),
        s1=s1, theta=jax.tree_util.tree_map(np.asarray, theta), e1=e1, alphas={n: np.asarray(a) for n, a in alphas.items()},
        tm={use: _grads(v) for use, v in tm.items()}, diff=_grads(diff), noise=noise,
        run_diff=(_np_states(run_diff[0]), run_diff[1]), run_tm=(_np_states(run_tm[0]), run_tm[1]),
        run_sur=(_np_states(run_sur[0]), run_sur[1]),
    )


def _grads(value_and_grad):
    """((loss, conv inputs), (parameter gradients, conv output cotangents)) as numpy:
    (loss, parameter gradients, {conv: (input, cotangent)})."""
    (loss, rec), (g, cts) = value_and_grad
    return (float(loss), jax.tree_util.tree_map(np.asarray, g),
            {n: (np.asarray(rec[n]), np.asarray(cts[n])) for n in rec})


def jparams_kernel(jparams, name):
    node = jparams
    for p in name.split("."):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return node["kernel"]


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


# ---------------------------------------------------------------------------
# the calibration set
# ---------------------------------------------------------------------------


def _random_states(S, seed, tie=False):
    """JAX-shaped states of the toy's layers with random logits (or, with
    `tie`, logits that give every step the same uncertainty)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, st in JQuantizedUNet.create(JConfig(**TOY), 4, 8).init_state(S).items():
        d = {f: np.asarray(getattr(st, f)) for f in FIELDS}
        G, C = d["alpha_logits"].shape[1:]
        logits = rng.normal(0, 1.5, (1 if tie else S, G, C)).astype(np.float32)
        d["alpha_logits"] = np.broadcast_to(logits, (S, G, C)).copy()
        out[name] = d
    return out


def test_alpha_uncertainty_matches_jax():
    np_states = _random_states(5, 1)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()}) for k, d in np_states.items()}
    got = cal.alpha_uncertainty(from_jax_qstates(np_states, device="cpu"), 5)
    # softmax / log of the same logits: the two `exp`s differ in the last bit (measured 1.0e-7 relative)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcal.alpha_uncertainty(jqs, 5)), rtol=4e-7)


@pytest.mark.parametrize("t_mode", ["real", "range", "random", "diff", "diff-ties", "diff-min_t"])
def test_select_calibration_images_matches_jax(t_mode):
    """All four t-modes, image for image (the "random" mode given JAX's
    normals); "diff" with a sample count, with every step tied (the last
    argmax wins) and with its min_t clamped to a 5-step schedule."""
    S, n = 5, 6
    rng = np.random.default_rng(2)
    xs_full = rng.standard_normal((S + 1, n, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw, jkw = {}, {}
    if t_mode == "random":
        jkw["key"] = key
        kw["normals"] = _t(np.asarray(jax.random.normal(key, (n,))))
    if t_mode.startswith("diff"):
        np_states = _random_states(S, 4, tie=t_mode == "diff-ties")
        count = np.zeros(S, np.float32) if t_mode == "diff-ties" else np.array([0, 1, 0, 2, 0], np.float32)
        jkw.update(qstates={k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()})
                            for k, d in np_states.items()}, sample_count=jnp.asarray(count))
        kw.update(qstates=from_jax_qstates(np_states, device="cpu"), sample_count=_t(count))
        if t_mode == "diff":
            kw["min_t"] = jkw["min_t"] = 1
    mode = t_mode.split("-")[0]
    jx, jt, jcount = jcal.select_calibration_images(jnp.asarray(xs_full), mode, num_steps=S, **jkw)
    x, t_sel, count = cal.select_calibration_images(_t(xs_full), mode, num_steps=S, **kw)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    if mode == "diff":
        assert int(t_sel) == int(jt) and int(t_sel) >= (1 if t_mode == "diff" else S - 1)
        if t_mode == "diff-ties":
            assert int(t_sel) == S - 1
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    else:
        assert t_sel is None and jt is None
    if mode == "random":
        with pytest.raises(ValueError, match="torch.Generator"):
            cal.select_calibration_images(_t(xs_full), "random", num_steps=S)
        x2, _, _ = cal.select_calibration_images(_t(xs_full), "random", num_steps=S,
                                                 generator=torch.Generator().manual_seed(0))
        assert x2.shape == x.shape


# ---------------------------------------------------------------------------
# stage 1 with the assignment init
# ---------------------------------------------------------------------------


def test_assignment_logits_match_jax():
    rng = np.random.default_rng(5)
    gr = np.sort(rng.uniform(-4, 6, (8, 2)), axis=1).astype(np.float32)
    snap_min = gr[rng.integers(0, 8, 128), 0] + rng.normal(0, 0.01, 128).astype(np.float32)
    snap_max = gr[rng.integers(0, 8, 128), 1]
    snap_min[:4] = snap_max[:4] = 0.0  # equidistant buckets: the first wins
    got = cal._assignment_logits(_t(gr), _t(snap_min), _t(snap_max))
    want = jcal._assignment_logits(jnp.asarray(gr), jnp.asarray(snap_min), jnp.asarray(snap_max))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {0.0, cal.ASSIGN_LOGIT} and (got.numpy() > 0).sum(axis=0).tolist() == [1] * 128


def test_stage1_assignment_init_matches_jax(chain):
    """Every conv at every step, given the input JAX's calibration forward
    gave it, gets JAX's update with the assignment init (the logits equal;
    the ranges within 4e-7 relative, measured 1.02e-7);
    the whole calibration seeds every layer's logits one-hot."""
    _, q, _ = _port()
    assert len(chain["records"]) == 2 * len(q.policy)
    for s, name, xin, want in chain["records"]:
        got, _ = cal._calibrate_one_conv(_t(xin), chain["qstates0"][name], q.policy[name], s, True, True)
        np.testing.assert_array_equal(got["alpha_logits"].numpy(), want["alpha_logits"], err_msg=name)
        for f in ("init_range", "act_min", "act_max", "group_ranges"):
            np.testing.assert_allclose(got[f].numpy(), want[f], rtol=4e-7, err_msg=f"{s} {name}.{f}")
    qs = cal.calibrate_ranges(q, chain["params"], q.init_state(len(SEQ), "cpu"), _t(chain["xs_in"]), SEQ,
                              assignment_init=True)
    for name, st in qs.items():
        a = st.alpha_logits.numpy()
        assert ((a == cal.ASSIGN_LOGIT).sum(axis=1) == 1).all() and ((a == 0) | (a == cal.ASSIGN_LOGIT)).all(), name


# ---------------------------------------------------------------------------
# stage 2 (differentiable group selection)
# ---------------------------------------------------------------------------


def _conv_kw(name):
    """The conv's stride and padding in the forward (its recorded input is already padded)."""
    return dict(stride=2, padding="VALID") if name.endswith("downsample.conv") else {}


def _grad_err(got, want):
    """The largest difference of any layer's gradient from JAX's, over the
    largest JAX gradient of the kind (a layer whose gradient is ~1e-13 has no
    meaningful relative error of its own)."""
    return max(np.abs(got[n] - want[n]).max() for n in want) / max(np.abs(want[n]).max() for n in want)


def test_stage2_loss_and_gradient_match_jax_teacher_forced(chain):
    """At step 1 on JAX's x_t, noise and logits.  The loss of the whole
    forward within a chained bound of JAX's (measured 4.1e-5: the forward's
    float-order code flips move eps, which the noise dominates).  Each
    layer's logit gradient, given the input JAX's forward gave its conv and
    the cotangent JAX's backward brought to the conv's output: the port's
    mixture-mode conv (`make_quant_conv_apply`) and entropy term against
    JAX's gradient of those logits (`_grad_err` measured 4.0e-6).  The whole
    backward is not compared: at 8 bits the code flips move the later
    layers' gradients by up to 0.3 mean relative (1e-3 at 16 bits)."""
    _, q, sched = _port()
    s1 = chain["s1"]
    want_loss, want_grad, sites = chain["diff"]
    alphas = {n: _t(a).requires_grad_(True) for n, a in chain["alphas"].items()}
    abar = torch.cumprod(1.0 - sched.betas, dim=0)
    t = int(chain["t_rev"][s1])
    with torch.no_grad():
        loss, _ = cal._stage2_loss(q, chain["params"], chain["qstates"], alphas, _t(chain["xs_in"][s1]),
                                   _t(chain["e1"]), abar[t], float(t), s1, 1.0)
    assert float(loss) == pytest.approx(want_loss, rel=1.6e-4)
    ca = make_quant_conv_apply(cal._apply_theta(chain["qstates"], {"alpha": alphas}), q.policy, s1, mode="mixture")
    total = sum(cal._alpha_entropy(a[s1], a.shape[1], a.shape[2]) for a in alphas.values())
    assert sorted(sites) == sorted(alphas)
    for name, (x, ct) in sites.items():
        total = total + (ca(name, _t(x), lookup(chain["params"], name), **_conv_kw(name)) * _t(ct)).sum()
    total.backward()
    assert not any(a.grad[0].any() for a in alphas.values())  # step 1's slice only
    err = _grad_err({n: a.grad.numpy() for n, a in alphas.items()}, want_grad)
    assert err < 1.6e-5, err


def _mixed(states, names):
    """Every layer's per-step mixed (min, max) channel ranges, the quantity the fold reads, flattened."""
    out = []
    for n in names:
        st = states[n]
        if isinstance(st, dict):
            st = from_jax_qstates({n: st}, device="cpu")[n]
        out += [torch.stack(mixed_ranges(st, s)).numpy().ravel() for s in range(len(SEQ))]
    return np.concatenate(out)


def test_stage2_whole_run_matches_jax(chain):
    """`calibrate_differentiable(attention_focus=True)`, one epoch, on JAX's
    draws: only the attention projections' logits move, and each step's
    loss and the layers' mixed ranges lie within a chained bound of JAX's
    (measured 2.1e-4 and 1.1e-3 mean relative; the run moves the ranges by
    2.3e-3 from stage 1's).  The logits themselves are
    not compared: Adam's first update moves each by about +-lr whatever its
    gradient's size, so an element whose tiny gradient changes sign with a
    code flip lands 2 lr away."""
    _, q, sched = _port()
    got, losses = cal.calibrate_differentiable(q, chain["params"], chain["qstates"], _t(chain["x0"]), SEQ, sched.betas,
                                               noise=_t(chain["noise"]), attention_focus=True)
    want, want_losses = chain["run_diff"]
    assert len(losses) == len(SEQ)
    np.testing.assert_allclose(losses, want_losses, rtol=8.4e-4)
    attn = [n for n in got if _is_attn(n)]
    for name, st in got.items():
        if _is_attn(name):
            assert not np.array_equal(st.alpha_logits.numpy(), chain["np_states"][name]["alpha_logits"]), name
        else:
            assert st.alpha_logits is chain["qstates"][name].alpha_logits
    rel = _rel(_mixed(got, attn), _mixed(want, attn))
    assert rel < 4.3e-3, rel
    assert _rel(_mixed(got, attn), _mixed(chain["np_states"], attn)) > 1e-3  # the run moved them
    with pytest.raises(ValueError, match="torch.Generator"):
        cal.calibrate_differentiable(q, chain["params"], chain["qstates"], _t(chain["x0"]), SEQ, sched.betas)


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_one_optimizer_update_matches_optax(chain, kind):
    """torch's AdamW (stage 2) and Adam (teacher-matched) against optax's
    adamw / adam on the same gradients, over the whole [S, G, C] logits: a
    first update with step 1's gradient, then one whose gradient is zero on
    step 1's slice, which still moves (Adam's moments; AdamW also decays
    every slice).  Measured at most 8.3e-7 (AdamW) and 4.8e-7 (Adam) apart,
    an ulp of the larger logits: the two order the update's terms
    differently."""
    ATOL = {"adamw": 3.3e-6, "adam": 1.9e-6}
    grads = {n: g for n, g in chain["diff"][1].items()}
    params = {n: a for n, a in chain["alphas"].items()}
    second = {n: np.concatenate([np.full_like(g[:1], 0.01), np.zeros_like(g[1:])]) for n, g in grads.items()}
    if kind == "adamw":
        opt, topt = optax.adamw(0.05, weight_decay=0.05), torch.optim.AdamW
        kw = dict(lr=0.05, weight_decay=0.05)
    else:
        opt, topt = optax.adam(0.02), torch.optim.Adam
        kw = dict(lr=0.02)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    st = opt.init(jp)
    tp = {n: _t(a).requires_grad_(True) for n, a in params.items()}
    tor = topt(list(tp.values()), **kw)
    after = []
    for g in (grads, second):
        upd, st = opt.update({n: jnp.asarray(v) for n, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for n, v in tp.items():
            v.grad = _t(g[n])
        tor.step()
        for n in tp:
            np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]), rtol=0, atol=ATOL[kind], err_msg=n)
        after.append({n: tp[n].detach().numpy()[1].copy() for n in tp})
    assert all(not np.array_equal(after[0][n], after[1][n]) for n in tp)  # slice 1 moved on a zero gradient


# ---------------------------------------------------------------------------
# stage 2, teacher-matched
# ---------------------------------------------------------------------------


def _theta(chain, variant):
    """Port leaves of JAX's teacher-forced theta, as `calibrate_teacher_matched` builds them for `variant`."""
    kw = VARIANTS[variant]
    names = [n for n in chain["theta"]["alpha"] if not kw.get("attention_focus") or _is_attn(n)]
    theta = {}
    if kw.get("train_alpha", True):
        theta["alpha"] = {n: _t(chain["theta"]["alpha"][n]).requires_grad_(True) for n in names}
    if kw.get("train_range_scale", True):
        theta["rho"] = {n: _t(chain["theta"]["rho"][n]).requires_grad_(True) for n in names}
    return theta


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_teacher_matched_loss_and_gradient_match_jax_teacher_forced(chain, variant):
    """At step 1 on JAX's trajectory input, eps and theta (alpha and a seeded
    rho on every layer; what a variant does not train stays at JAX's theta,
    folded into the states it starts from).  `_teacher_matched_loss` within
    a chained bound of JAX's (measured 1.7e-3 through the fake-quant model,
    1.3e-3 through the surrogate: the forwards' code flips).  The variant's
    gradients layer by layer, given each conv's input from JAX's forward and
    the cotangent JAX's backward brought to its output: the port's conv
    (`make_quant_conv_apply` mode "infer", or `surrogate_conv_apply` with the
    extras) against JAX's gradient (`_grad_err`, measured per variant and
    parameter beside `TM_GRAD_BOUND`)."""
    _, q, _ = _port()
    s1 = chain["s1"]
    use = bool(VARIANTS[variant].get("extras"))
    want_loss, want_grad, sites = chain["tm"][use]
    theta = _theta(chain, variant)
    fwd = chain["params"] if use else chain["qparams"]
    base = cal._apply_theta(chain["qstates"], {k: {n: _t(v) for n, v in f.items() if n not in theta.get(k, {})}
                                               for k, f in chain["theta"].items()})
    extras = _to_port(chain["extras"]) if use else None
    with torch.no_grad():
        loss = cal._teacher_matched_loss(q, fwd, base, theta, _t(chain["xs_in"][s1]), _t(chain["eps_ref"][s1]),
                                         float(chain["t_rev"][s1]), s1, serving_extras=extras)
    assert float(loss) == pytest.approx(want_loss, rel=5.3e-3 if use else 6.6e-3)
    qs = cal._apply_theta(base, theta)
    ca = (cal.surrogate_conv_apply(q, qs, extras, s1) if use
          else make_quant_conv_apply(qs, q.policy, s1, mode="infer"))
    total = sum((ca(name, _t(x), lookup(fwd, name), **_conv_kw(name)) * _t(ct)).sum() for name, (x, ct) in sites.items())
    total.backward()
    for kind, fields in theta.items():
        err = _grad_err({n: v.grad.numpy() for n, v in fields.items()}, {n: want_grad[kind][n] for n in fields})
        assert err < TM_GRAD_BOUND[variant, kind], (kind, err)


@pytest.mark.parametrize("run", ["fake_quant", "serving_extras"])
def test_teacher_matched_whole_run_matches_jax(chain, run):
    """Two passes of `calibrate_teacher_matched`, each step's loss within a
    chained bound of JAX's: alpha and rho on every layer through the
    fake-quant model (measured 3.18e-2 at most; the returned mixed ranges
    6.8e-3 from JAX's, which moved 2.9e-2 from stage 1's), and on the
    attention projections through the surrogate with the extras (measured
    1.81e-2).  The surrogate run's result is not compared: at step 1 the
    second pass's loss lies within 2% of the first's (JAX's 0.011984 against
    0.011961, the port's 0.011767 against 0.011883), so the two keep
    different iterates (JAX's the init)."""
    _, q, _ = _port()
    if run == "fake_quant":
        kw, fwd, (want, want_losses) = {}, chain["qparams"], chain["run_tm"]
    else:
        kw = dict(attention_focus=True, serving_extras=_to_port(chain["extras"]))
        fwd, (want, want_losses) = chain["params"], chain["run_sur"]
    got, losses = cal.calibrate_teacher_matched(q, fwd, chain["qstates"], _t(chain["xs_in"]), _t(chain["eps_ref"]),
                                                SEQ, lr=TM_LR, epochs=TM_EPOCHS, **kw)
    assert len(losses) == TM_EPOCHS * len(SEQ)
    np.testing.assert_allclose(losses, want_losses, rtol=0.127 if run == "fake_quant" else 7.2e-2)
    if run == "fake_quant":
        rel = _rel(_mixed(got, list(got)), _mixed(want, list(got)))
        assert rel < 2.7e-2, rel
        for name, st in got.items():  # every layer's logits and ranges were trained
            assert not np.array_equal(st.group_ranges.numpy(), chain["np_states"][name]["group_ranges"]), name


def test_teacher_matched_keeps_each_steps_best_iterate(chain):
    """At a learning rate that overshoots, every step's returned objective is
    the least its losses reached, which is at most its init's (the first
    epoch's loss), re-evaluated on the returned states."""
    _, q, _ = _port()
    S = len(SEQ)
    got, losses = cal.calibrate_teacher_matched(q, chain["qparams"], chain["qstates"], _t(chain["xs_in"]),
                                                _t(chain["eps_ref"]), SEQ, lr=1.0, epochs=3)
    per_step = np.asarray(losses).reshape(3, S)
    assert (per_step[1:] > per_step[0]).any()  # some later iterate is worse: the selection matters
    for s in range(S):
        with torch.no_grad():
            obj = float(cal._teacher_matched_loss(q, chain["qparams"], got, {}, _t(chain["xs_in"][s]),
                                                  _t(chain["eps_ref"][s]), float(chain["t_rev"][s]), s))
        assert obj == pytest.approx(per_step[:, s].min(), rel=1e-6) and obj <= per_step[0, s] * (1 + 1e-6), s


def test_teacher_matched_refuses_asymmetric_and_trains_nothing_without_parameters(chain):
    """`symmetric=False` (the interception runtime's asymmetric weight grid)
    is taken: the fake-quant forward reads no weight grid, so without
    `serving_extras` a run gives symmetric=True's bits (the surrogate's
    asymmetric conv is held to JAX's in tests/test_torch_int8_runtime.py).
    With no parameter to train the states come back as they are."""
    _, q, _ = _port()
    args = (q, chain["qparams"], chain["qstates"], _t(chain["xs_in"]), _t(chain["eps_ref"]), SEQ)
    asym, sym = (cal.calibrate_teacher_matched(*args, epochs=1, symmetric=flag) for flag in (False, True))
    assert asym[1] == sym[1] and all(torch.equal(asym[0][n].alpha_logits, sym[0][n].alpha_logits) for n in sym[0])
    assert cal.calibrate_teacher_matched(*args, train_alpha=False, train_range_scale=False) == (chain["qstates"], [])
    assert lookup(chain["params"], "mid.attn_1")["gamma"].item() == 1.0
