"""PyTorch port vs the JAX package: the serving-throughput sweep
(`tools/serving_sweep.py`) on JAX's tiny grid (tests/test_misc_paths.py's
`test_serving_sweep_tool_runs_tiny`), its JSON lines (the header equal to
JAX's, one row a variant, the winner), the four fold forms (the chunked
and packed runs equal to the unchunked one to the bit), and its error
handling: out of memory prints an error row and the sweep goes on, any
other failure raises."""
import json

import pytest
import torch

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.tools.serving_sweep import sweep as j_sweep
from attentiondm_tpu_torch.models.unet import UNetConfig
from attentiondm_tpu_torch.tools import serving_sweep as ss

TINY = dict(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_serving_sweep_tool_runs_tiny(capsys):
    """JAX's tiny grid: both variants give a finite rate; the JSON lines are
    JAX's header (equal to JAX's own), a row per variant and the winner."""
    rows = ss.sweep("cifar10.yml", 2, [2], [None, 2], reps=1, ucfg_override=UNetConfig(**TINY), device="cpu")
    assert len(rows) == 2
    assert all(r["img_per_sec"] > 0 for r in rows)
    lines = _lines(capsys)
    j_sweep("cifar10.yml", 2, [2], [None], reps=1, ucfg_override=JConfig(**TINY))
    jlines = _lines(capsys)
    assert lines[0] == jlines[0]
    assert lines[1:3] == rows and [(r["batch"], r["step_chunk"]) for r in rows] == [(2, None), (2, 2)]
    assert lines[3] == {"winner": max(rows, key=lambda r: r["img_per_sec"])}
    assert set(jlines[1]) == set(rows[0]) and set(jlines[2]) == {"winner"}


def test_fold_forms_bit_equal_and_recorded(capsys):
    record = {}
    rows = ss.sweep("cifar10.yml", 3, [1, 2], [None, 2, "shared", "packed"], reps=2, ucfg_override=UNetConfig(**TINY),
                    device="cpu", record=record)
    assert [(r["batch"], r["step_chunk"]) for r in rows] == [(b, c) for b in (1, 2)
                                                             for c in (None, 2, "shared", "packed")]
    assert all(len(r["all"]) == 2 and r["img_per_sec"] == round(max(r["all"]), 3) for r in rows)
    for b in (1, 2):
        base = record[(b, None)]["out"]
        assert base.shape == (b, 8, 8, 3) and torch.isfinite(base).all()
        assert torch.equal(record[(b, 2)]["out"], base)
        assert torch.equal(record[(b, "packed")]["out"], base)
        shared = record[(b, "shared")]["out"]
        assert torch.isfinite(shared).all() and (shared - base).abs().mean() < 0.1 * base.abs().mean()
    # on the CPU every kernel wrapper runs its plain version: no launches
    assert all(set(v["launches"].values()) == {0} for v in record.values())
    assert [ln for ln in _lines(capsys) if "error" in ln] == []


def test_out_of_memory_prints_an_error_row_and_the_sweep_goes_on(monkeypatch, capsys):
    from attentiondm_tpu_torch.quant import int8_serving

    real = int8_serving.serving_ddim_sampler

    def flaky(*a, **kw):
        if kw.get("step_chunk") == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")
        return real(*a, **kw)

    monkeypatch.setattr(int8_serving, "serving_ddim_sampler", flaky)
    rows = ss.sweep("cifar10.yml", 2, [2], [None, 2], reps=1, ucfg_override=UNetConfig(**TINY), device="cpu")
    assert [r["step_chunk"] for r in rows] == [None]
    errors = [ln for ln in _lines(capsys) if "error" in ln]
    assert errors == [{"batch": 2, "step_chunk": 2, "error": "CUDA out of memory. Tried to allocate 80.00 GiB"}]


def test_other_failures_raise(monkeypatch):
    from attentiondm_tpu_torch.quant import int8_serving

    def broken(*a, **kw):
        raise ValueError("no such fold")

    monkeypatch.setattr(int8_serving, "serving_ddim_sampler", broken)
    with pytest.raises(ValueError, match="no such fold"):
        ss.sweep("cifar10.yml", 2, [2], [None], reps=1, ucfg_override=UNetConfig(**TINY), device="cpu")


def test_cli_parses_jax_flags(monkeypatch):
    got = {}
    monkeypatch.setattr(ss, "sweep", lambda *a, **kw: got.update(args=a, kw=kw) or [])
    ss.main(["--config", "church.yml", "--timesteps", "20", "--batches", "8,16", "--step_chunks",
             "none,0,5,Shared,packed", "--bitwidth", "8", "--a_bitwidth", "8", "--skip_type", "uniform", "--reps", "4",
             "--attn_int8", "--device", "cpu"])
    assert got["args"] == ("church.yml", 20, [8, 16], [None, None, 5, "shared", "packed"])
    assert got["kw"] == dict(w_bit=8, a_bit=8, skip_type="uniform", reps=4, attn_int8=True, device="cpu")
    assert ss.parse_chunks("none") == [None]
    assert ss.parse_chunks(" 1, 2") == [1, 2]
