"""The serving call's spans (`adm.*`, opened by `utils/profiling.trace_annotation`)
on toy UNets at W4A8 through `serving_ddim_sampler(..., plain=True)`: with no
profiler running no span reaches `record_function`; under torch.profiler a
two-step call emits the spans its config implies, no leaf span opens inside
another, and the output is the same to the bit; the benchmark harness's
attribute swaps (`portbench/harness/program.py`) still see every block."""
import json

import pytest
import torch

from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, iter_conv_layers, lookup, unet_init
from attentiondm_tpu_torch.ops.checks import _k3_site, attention_sites, fused_block
from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEAVES = ("adm.views", "adm.temb", "adm.entry", "adm.halo", "adm.quant_io", "adm.exit", "adm.skip", "adm.update")
# "fused": every resblock on the fused chain, both attention blocks K3; "unfused": resblocks on the unfused
# chain, attention at 8² off the fold (fake-quant) and at 4² composed around the float32 core
TOYS = {
    "fused": dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0),
    "unfused": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8, 4), resolution=8, dropout=0.0),
}
SEQ = [0, 500]  # two steps


@pytest.fixture(scope="module", params=sorted(TOYS))
def toy(request):
    """A toy UNet's seeded weights, the ranges a calibration would leave
    ([-1, 4] per group), its plain serving sampler and an input."""
    cfg = UNetConfig(**TOYS[request.param])
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(len(SEQ), "cpu")
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    sample = serving_ddim_sampler(q, params, qstates, SEQ, betas, plain=True)
    x = torch.randn((2, cfg.resolution, cfg.resolution, 3), generator=torch.Generator().manual_seed(1))
    return dict(name=request.param, cfg=cfg, params=params, sample=sample, x=x)


def _blocks(cfg):
    """(resblock names, attention block names) of one forward, from the config."""
    names = [n for n, _c, _k in iter_conv_layers(cfg)]
    res = [n.rsplit(".", 1)[0] for n in names if n.endswith(".conv1")]
    attn = [n.rsplit(".", 1)[0] for n in names if n.endswith(".q")]
    return res, attn


def _expected_per_step(cfg, params):
    """{span: count} of one serving step, from the config and the weights'
    shapes: a resblock on the fused chain has one GroupNorm entry (norm2 is
    K2 / K6's), one on the unfused chain two; an attention block that K3
    takes whole has neither an entry nor an exit span, any other one of
    each; conv_out has one entry."""
    res, attn = _blocks(cfg)
    entries = 1  # norm_out
    for b in res:
        _kh, _kw, cin, cout = lookup(params, f"{b}.conv1")["kernel"].shape
        entries += 1 if fused_block(cin, cout) else 2
    k3 = {site for site, L, C in attention_sites(cfg) if _k3_site(L, C)}
    return {"adm.step": 1, "adm.views": 1, "adm.update": 1, "adm.attn": len(attn),
            "adm.entry": entries + len(set(attn) - k3), "adm.exit": len(res) + len(set(attn) - k3)}


def _trace(sample, x, tmp_path):
    """The sampler's output under torch.profiler (CPU activity), and the
    `adm.*` host ranges of its Chrome trace as (name, start, end, thread)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sample(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("adm.")]
    return out, spans


def test_no_span_reaches_record_function_without_a_profiler(toy, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) reached with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.trace_annotation("adm.step") is profiling.trace_annotation("adm.halo")  # the shared no-op
    assert torch.isfinite(toy["sample"](toy["x"])).all()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError, match="adm.step"):
        profiling.trace_annotation("adm.step")  # the gate opens while a profiler collects


def test_a_traced_call_emits_the_spans_of_its_config(toy, tmp_path):
    _out, spans = _trace(toy["sample"], toy["x"], tmp_path)
    counts = {}
    for name, *_ in spans:
        counts[name] = counts.get(name, 0) + 1
    steps = len(SEQ)
    want = {k: v * steps for k, v in _expected_per_step(toy["cfg"], toy["params"]).items()}
    assert counts["adm.sample"] == 1
    assert {k: counts.get(k, 0) for k in want} == want
    # every leaf lies inside a step, every step inside the call
    (call,) = [s for s in spans if s[0] == "adm.sample"]
    steps_ = [s for s in spans if s[0] == "adm.step"]
    assert all(call[1] <= s[1] and s[2] <= call[2] for s in steps_)
    assert all(any(st[1] <= s[1] and s[2] <= st[2] for st in steps_) for s in spans if s[0] in LEAVES)
    assert {"adm.temb", "adm.halo", "adm.quant_io", "adm.skip"} <= set(counts)


def test_no_leaf_span_opens_inside_another(toy, tmp_path):
    _out, spans = _trace(toy["sample"], toy["x"], tmp_path)
    leaves = sorted((s for s in spans if s[0] in LEAVES), key=lambda s: (s[3], s[1], -s[2]))
    assert len(leaves) > 10
    for a, b in zip(leaves, leaves[1:]):
        if a[3] == b[3]:
            assert b[1] >= a[2], f"{b[0]} opens at {b[1]} inside {a[0]} ({a[1]} to {a[2]})"


def test_output_is_bit_equal_with_and_without_the_profiler(toy, tmp_path):
    plain = toy["sample"](toy["x"])
    traced, spans = _trace(toy["sample"], toy["x"], tmp_path)
    assert spans and torch.equal(plain, traced)


def test_the_harness_swaps_still_see_every_block(toy):
    from portbench.harness import program

    seen = []
    with program.Blocks(lambda step, name, h_in, h_out: seen.append((step, name))):
        toy["sample"](toy["x"])
    res, attn = _blocks(toy["cfg"])
    assert sorted(seen) == sorted((s, b) for s in range(len(SEQ)) for b in res + attn)
