"""ADM's UNet on the port (models/adm.py and its serving path) at a toy size
on the CPU: the float forward against `tests/adm_oracle.py` (guided-diffusion's
module tree) through the state-dict converter, the legacy qkv split, the
scale-shift fold, the int8-domain upsample, GroupNorm at eps 1e-5 in every
plain version, the launch counts, the served sampler against the benchmark's
plain reference, and a dry run of a toy ADM cell added to a copy of the
benchmark by files alone.  Torch only (no JAX chain); about 20 s on one
worker."""
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from attentiondm_tpu_torch.config import dict2namespace
from attentiondm_tpu_torch.diffusion.sampling import ddim_step, step_rule
from attentiondm_tpu_torch.models import adm
from attentiondm_tpu_torch.models.unet import UNetConfig, group_norm, unet_apply, unet_init
from attentiondm_tpu_torch.ops import checks, fused_gn
from attentiondm_tpu_torch.ops.attention import takes_flash
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block_ref
from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas_ref
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

sys.path.insert(0, str(Path(__file__).resolve().parent))
import adm_oracle  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def toy_cfg(num_channels=64, attention_resolutions=(16, 8), channel_mult=(1, 2, 2)):
    """ADM's flags at 32^2: 64 channels a head, so (16, 8) attend in two heads
    of 128 channels and (32,) in one of 64."""
    ns = dict2namespace({"model": {"type": "adm", "num_channels": num_channels, "channel_mult": list(channel_mult),
                                   "num_res_blocks": 1, "attention_resolutions": list(attention_resolutions),
                                   "num_head_channels": 64, "use_scale_shift_norm": True, "resblock_updown": True,
                                   "learn_sigma": True, "dropout": 0.0},
                         "data": {"image_size": 32, "channels": 3}})
    return UNetConfig.from_config(ns)


def _oracle(ares, seed=0):
    torch.manual_seed(seed)
    m = adm_oracle.from_flags(32, 64, (1, 2, 2), 1, ares, 64)
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(torch.randn_like(prm) * 0.2)
    return m


@pytest.mark.parametrize("ares", [(16, 8), (32,)])
def test_unet_apply_matches_the_oracle_through_the_converter(ares):
    cfg = toy_cfg(attention_resolutions=ares)
    m = _oracle(list(ares))
    p = adm.from_guided_diffusion(m.state_dict(), cfg)
    x, t = torch.randn(2, 3, 32, 32), torch.tensor([3.0, 700.0])
    with torch.no_grad():
        want = m(x, t).permute(0, 2, 3, 1)
        got = unet_apply(p, cfg, x.permute(0, 2, 3, 1), t)
    assert got.shape == (2, 32, 32, 6)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_config_blocks_and_converter_are_strict():
    cfg = toy_cfg()
    kinds = [b[0] for b in adm.adm_blocks(cfg)]
    assert kinds.count("res") == 3 + 2 + 2 + 6 + 2 and kinds.count("attn") == 2 + 1 + 4
    sd = _oracle([16, 8]).state_dict()
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="unmapped"):
        adm.from_guided_diffusion(sd, cfg)
    sd.pop("extra.weight")
    sd.pop("out.2.bias")
    with pytest.raises(KeyError, match="missing"):
        adm.from_guided_diffusion(sd, cfg)
    bedroom = UNetConfig.from_config(__import__("attentiondm_tpu_torch.config", fromlist=["load_config"])
                                     .load_config("adm_lsun_bedroom.yml"))
    assert (bedroom.ch, bedroom.out_ch, bedroom.gn_eps, bedroom.ch_mult) == (256, 6, 1e-5, (1, 1, 2, 2, 4, 4))
    blocks = adm.adm_blocks(bedroom)
    assert sum(b[0] == "res" for b in blocks) == 42 and sum(b[0] == "attn" for b in blocks) == 16
    assert sum(b[5] is not None for b in blocks) == 10


def test_legacy_qkv_split_matches_qkv_attention_legacy():
    torch.manual_seed(1)
    B, C, L, heads = 2, 128, 20, 2
    conv = torch.nn.Conv1d(C, 3 * C, 1)
    x = torch.randn(B, C, L)
    want = adm_oracle.QKVAttentionLegacy(heads)(conv(x)).detach()
    (wq, bq), (wk, bk), (wv, bv) = adm.split_legacy_qkv(conv.weight.detach(), conv.bias.detach(), heads)
    xl = x.transpose(1, 2)
    q, k, v = (xl @ w.t() + b for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    from attentiondm_tpu_torch.ops.attention import head_attention

    got = head_attention(q, k, v, heads, scale=(C // heads) ** -0.5).transpose(1, 2)
    assert float((got - want).abs().max()) < 1e-5


def test_head_attention_takes_autograd():
    """K11 has no backward: several heads raise where autograd would need
    gradients, as `flash_attention` does, rather than give way to plain
    torch.  ADM's float forward differentiates through its own named dense
    core, equal in value to K11's plain version."""
    from attentiondm_tpu_torch.ops.attention import head_attention

    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 64, 128, generator=g) for _ in range(3))
    want = head_attention(q, k, v, 2)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        head_attention(qg, k, v, 2)
    got = adm.dense_head_attention(qg, k, v, 2, 64 ** -0.5)
    got.sum().backward()
    assert float((got.detach() - want).abs().max()) < 1e-5 and qg.grad is not None and qg.grad.abs().sum() > 0


def test_float_forward_differentiates_through_the_dense_core(monkeypatch):
    """Stage 2 / 3's refinement differentiates ADM's float forward: its
    attention then runs `adm.dense_head_attention`, never K11's wrapper, and
    the input's gradient matches the oracle's."""
    from attentiondm_tpu_torch.ops import attention

    def refuse(*a, **k):
        raise AssertionError("head_attention called with gradients wanted")

    cfg = toy_cfg()
    m = _oracle([16, 8], seed=3)
    p = adm.from_guided_diffusion(m.state_dict(), cfg)
    x, t = torch.randn(2, 3, 32, 32), torch.tensor([11.0, 512.0])
    xw = x.clone().requires_grad_(True)
    m(xw, t).square().sum().backward()
    monkeypatch.setattr(attention, "head_attention", refuse)
    xg = x.permute(0, 2, 3, 1).clone().requires_grad_(True)
    unet_apply(p, cfg, xg, t).square().sum().backward()
    want, got = xw.grad.permute(0, 2, 3, 1), xg.grad
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_scale_shift_fold_matches_gn_times_one_plus_scale_plus_shift():
    g = torch.Generator().manual_seed(2)
    B, HW, C = 2, 64, 128
    dot = (torch.randn(B, 8, 8, C, generator=g) * 3).to(torch.bfloat16)
    gamma, beta = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    scale, shift = torch.randn(C, generator=g) * 0.3, torch.randn(C, generator=g)
    h = dot.to(torch.float32).reshape(B, HW, C)
    gn = fused_gn.gn_normalize(h, torch.ones(C), torch.zeros(C), 1e-5)
    want = (gn * gamma + beta) * (1 + scale) + shift
    got = fused_gn.gn_normalize(h, gamma * (1 + scale), beta * (1 + scale) + shift, 1e-5)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    # and K2's plain version takes the folded affine with a zero temb add as the served block hands it
    ones, zeros = torch.ones(C), torch.zeros(C)
    s, z = torch.full((C,), 20.0), torch.zeros(C)
    codes = fused_gn.epilogue_gn_swish_quant(dot, ones, zeros, zeros.expand(B, -1), gamma * (1 + scale),
                                             beta * (1 + scale) + shift, s, z, 8, eps=1e-5)
    ref = fused_gn.quant_i8(fused_gn.swish(want), s, z, 8).reshape(dot.shape)
    assert int((codes.int() - ref.int()).abs().max()) <= 1 and float((codes != ref).float().mean()) < 1e-3


def test_quantize_then_upsample_equals_upsample_then_quantize():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 128, generator=g) * 4
    scale, zp = torch.rand(128, generator=g) * 30 + 1, torch.randn(128, generator=g) * 5
    a = srv._resample(fused_gn.quant_i8(x, scale, zp, 8), "up")
    b = fused_gn.quant_i8(srv._resample(x, "up"), scale, zp, 8)
    assert a.dtype == torch.int8 and torch.equal(a, b)


def _eps_matters(x):
    """x of small variance a group, where eps 1e-5 and 1e-6 give other codes."""
    return x * 3e-3


def test_every_plain_groupnorm_takes_eps():
    g = torch.Generator().manual_seed(4)
    B, H, C = 2, 8, 128
    x = _eps_matters(torch.randn(B, H, H, C, generator=g))
    gamma, beta = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g) * 0.1
    s, z = torch.full((C,), 20.0), torch.zeros(C)
    want5 = group_norm(x, {"scale": gamma, "bias": beta}, eps=1e-5)
    xf = x.reshape(B, H * H, C)
    # K4's, K2's and K6's plain versions, and the plain entry: the codes of GN at 1e-5, not at 1e-6
    versions = {
        "K4": lambda e: fused_gn.gn_act_quant(x, gamma, beta, [(s, z, 8)], act="none", eps=e)[0],
        "K2": lambda e: fused_gn.epilogue_gn_swish_quant_ref(x.to(torch.bfloat16), torch.ones(C), torch.zeros(C),
                                                             torch.zeros(B, C), gamma, beta, s, z, 8, e),
        "K6": lambda e: fused_gn.epilogue_gn_swish_quant_blocked_ref(x.to(torch.bfloat16), torch.ones(C),
                                                                     torch.zeros(C), torch.zeros(B, C), gamma, beta,
                                                                     s, z, 8, e),
        "xla": lambda e: srv.gn_act_quant_xla(x, {"scale": gamma, "bias": beta}, [(s, z, 8)], act="none", eps=e)[0],
    }
    for kind, fn in versions.items():
        got5, got6 = fn(1e-5), fn(1e-6)
        src = want5 if kind in ("K4", "xla") else group_norm(x.to(torch.bfloat16).to(torch.float32),
                                                            {"scale": gamma, "bias": beta}, eps=1e-5)
        if kind in ("K2", "K6"):
            src = fused_gn.swish(src)
        ref = fused_gn.quant_i8(src, s, z, 8)
        assert float((got5 != ref).float().mean()) < 2e-3 and int((got5.int() - ref.int()).abs().max()) <= 1, kind
        assert float((got5 != got6).float().mean()) > 0.05, kind
    # K7's sums finalized at eps, K3's and K12's plain versions
    sums = torch.stack([xf.sum(1).reshape(B, 32, 4).sum(-1), (xf * xf).sum(1).reshape(B, 32, 4).sum(-1)], 1)
    mean, rstd = fused_gn.gn_finalize_sums(sums, H * H, 4, 1e-5)
    xg = xf.reshape(B, H * H, 32, 4)
    assert torch.allclose(rstd, torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-5), rtol=1e-3)
    eye = torch.eye(C, dtype=torch.int8)
    w = (eye, torch.ones(C), torch.zeros(C))
    qp = [(s, z, 8)] * 3
    k3 = [fused_attention_block_ref(xf, gamma, beta, qp, [w] * 3, (s, z, 8), w, scale=C ** -0.5, eps=e)
          for e in (1e-5, 1e-6)]
    assert not torch.equal(k3[0], k3[1])
    k12 = [resblock_pallas_ref(x, torch.zeros(B, C), gamma, beta, (s, z), torch.zeros(9 * C, C, dtype=torch.int8),
                               (torch.ones(C), torch.zeros(C)), gamma, beta, (s, z),
                               torch.zeros(9 * C, C, dtype=torch.int8), (torch.ones(C), torch.zeros(C)), eps=e,
                               out_dtype=torch.float32) for e in (1e-5, 1e-6)]
    assert torch.equal(k12[0], k12[1])  # zero weights: the residual passes whatever the entry's eps


def test_learn_sigma_output_steps_on_its_eps_half():
    g = torch.Generator().manual_seed(5)
    x, out = torch.randn(2, 4, 4, 3, generator=g), torch.randn(2, 4, 4, 6, generator=g)
    at, at_next = torch.tensor(0.5), torch.tensor(0.7)
    got, _ = step_rule("ddim")(0, x, out, torch.tensor(500), at, at_next)
    want, _ = ddim_step(x, out[..., :3], at, at_next, 0.0, torch.zeros_like(x))
    assert torch.equal(got, want)


def _count_calls(cfg, batch):
    """The kernel wrappers the serving step calls (on the CPU their plain
    versions run, so `.launches` stay 0): counted by kind as a card would
    launch them."""
    p = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qs = q.init_state(1, "cpu")
    for st in qs.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -3.0, 3.0
    rt = srv.prepare_serving_runtime(q, p, qs)
    counts, saved = {}, {}
    kinds = {"_k1": lambda *a: "K1",
             "epilogue_gn_swish_quant": lambda d, *a: fused_gn.epilogue_route(d.shape, d.dtype),
             "gn_act_quant": lambda *a: "K4",
             "head_attention": lambda q_, k_, v_, heads, *a: "K11" if heads > 1 or takes_flash(q_.shape[1],
                                                                                              q_.shape[2]) else None,
             "fused_attention_block": lambda *a: "K3"}
    for name, kind in kinds.items():
        saved[name] = getattr(srv, name)

        def call(*a, _fn=saved[name], _kind=kind, **kw):
            k = _kind(*a)
            if k:
                counts[k] = counts.get(k, 0) + 1
            return _fn(*a, **kw)

        setattr(srv, name, call)
    try:
        with torch.no_grad():
            srv.serving_unet_apply(p, cfg, q, rt, qs, torch.randn(batch, 32, 32, 3), torch.tensor(5.0).expand(batch),
                                   0, attn_int8=False)
    finally:
        for name, fn in saved.items():
            setattr(srv, name, fn)
    return counts


@pytest.mark.parametrize("num_channels,ares", [(64, (16, 8)), (128, (16, 8)), (64, (32,))])
def test_expected_launches_match_the_serving_steps_calls(num_channels, ares):
    cfg = toy_cfg(num_channels, ares)
    want = {k: v for k, v in checks.expected_launches(cfg, 1, 2).items() if v and k in ("K1", "K2", "K6", "K4",
                                                                                         "K11", "K3")}
    assert _count_calls(cfg, 2) == want


def test_bedroom_launch_plan():
    from attentiondm_tpu_torch.config import load_config

    cfg = UNetConfig.from_config(load_config("adm_lsun_bedroom.yml"))
    n = checks.expected_launches(cfg, 10, 16)
    assert n["K11"] == 160 and n["K3"] == 0 and n["K2"] + n["K6"] == 420 and n["K7"] == n["K12"] == 0
    assert n["K1"] == 10 * (2 * 42 + 4 * 16 + 1 + sum(1 for b in adm.adm_blocks(cfg) if b[0] == "res" and b[3] != b[4]))
    assert n["K4"] == 10 * (42 - 5 + 16 + 1)
    assert checks.gn_refused(cfg, 16) == [] and checks.attention_plan(cfg)["refused"] == []
    with pytest.raises(ValueError, match="float32 core"):
        srv._require_attention_flags(cfg, True, None, None)


def _add_toy_adm(root: Path) -> str:
    """A toy ADM configuration (the bedroom config at 32^2, 64 channels, 1-2,
    attention in one head at 32^2 and two at 16^2), a 2-image DDIM-2 mix and
    their cell, added to the copy at `root` by new files and new
    BENCHMARK.json entries only."""
    cfg = json.loads((root / "portbench/configs/adm-lsun-bedroom.json").read_text())
    cfg["data"]["image_size"] = 32
    cfg["model"].update(num_channels=64, channel_mult=[1, 2], num_res_blocks=1, attention_resolutions=[32, 16])
    (root / "portbench/configs/admtoy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/closed-b16-ddim10-uniform.json").read_text())
    mix.update(batch=2, timesteps=2)
    (root / "portbench/traffic/admtoy-mix.json").write_text(json.dumps(mix))
    (root / "portbench/workloads/admtoy-cell.json").write_text(json.dumps(
        {"teacher_gap": 1e-4, "fold_gap": 1e-4, "block_gap": 2e-3, "block_median": 1e-4, "image_gap": 0.05}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "admtoy", "source": "test", "file": "portbench/configs/admtoy.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "admtoy-cell", "config": "admtoy", "traffic": "admtoy-mix", "chips": 1,
                               "why": "toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
    return "admtoy-cell"


def test_dry_run_of_a_toy_adm_cell_added_by_files_alone(tmp_path):
    from portbench.harness.registry import Registry
    from portbench.harness.runner import execute

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cell = _add_toy_adm(tmp_path)
    assert {p: p.read_bytes() for p in before} == before  # no file that was there changed
    r = execute(Registry(tmp_path), cell, 2 ** 31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["metrics"] == {}
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


def test_served_sampler_matches_the_plain_reference(tmp_path):
    """The port's plain sampler against `portbench/reference/adm_w4a8.py`, as
    the DDPM's reference test: the teacher and the first stage-1 ranges to
    float32 rounding, the fold's codes, each block (every resblock and
    attention block of every step seen) to float32 rounding, the images
    within the int8 chain's spread."""
    from portbench.harness import params as P
    from portbench.harness import program as PR
    from portbench.harness.check import BlockCheck, Subject, block_gaps, fold_gap, image_gaps
    from portbench.reference import adm_w4a8 as ref

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _add_toy_adm(tmp_path)
    cfg = json.loads((tmp_path / "portbench/configs/admtoy.json").read_text())
    mix = json.loads((tmp_path / "portbench/traffic/admtoy-mix.json").read_text())
    dev = torch.device("cpu")
    params = P.draw_params(ref.param_layout(cfg), P.seeded(3, 0, dev), dev)
    x_cal = torch.randn((2, 32, 32, 3), generator=P.seeded(3, 1, dev))
    x = torch.randn((2, 32, 32, 3), generator=P.seeded(3, 2, dev))
    prog = PR.Program(cfg, mix, dev)
    xs = prog.teacher(params, x_cal)
    qstates = prog.calibrate(params, xs)
    sample = prog.sampler(params, qstates)
    ranges = PR.Program.ranges(qstates)
    sched = ref.schedule(cfg, mix["timesteps"], mix["skip_type"], dev)
    xs_ref = ref.teacher_inputs(params, cfg, x_cal, sched)
    assert ((xs - xs_ref).abs().max() / xs_ref.abs().max()) < 1e-5
    rr = ref.calibrate(params, cfg, xs_ref, sched)
    # stage 1 at the first sites of the first step, on the same images: later steps' inputs differ by the
    # teacher's rounding, on which the range search's argmin may flip (harness/check.py)
    for name in ("conv_in", "down.0.block.0.conv1"):
        assert torch.allclose(rr[name][0], ranges[name][0], rtol=1e-5, atol=1e-5)
    subject = Subject(xs, ranges, lambda n, s, shape: PR.Program.fold_step(sample.runtime, n, s, shape), None, None)
    assert fold_gap(ref, cfg, params, subject) < 1e-5
    blocks = BlockCheck(ref, cfg, params, ranges, sched)
    with PR.Blocks(blocks):
        out = sample(x)
    assert len(blocks.gaps) == 2 * len(ref.blocks(cfg)) == 2 * 17
    assert block_gaps(blocks.gaps)[1] < 1e-4
    folds = ref.fold(params, cfg, ranges)
    assert max(image_gaps(out, ref.serve(params, cfg, folds, ranges, sched, x))) < 0.03
