"""PyTorch port vs the JAX package: the quality ladder's serving rows
(`run_protocol(serving=True)`: int8_w4a8 at the f32 and bf16 residual
streams, one fold a row, through the kernels' plain versions on the CPU),
on tests/test_torch_quality_protocol.py's toy, draws and bands; then the
`--adaround` ladder on the port alone: `--weight_rows gptq
--stage2_teacher`, where JAX's protocol raises NameError (its `extras` is
the AR leg's, `attentiondm_tpu/tools/quality_protocol.py:534-545`), and
the Gram batch, which JAX caps silently above 32^2 (:461-463) and the port
prints."""
import pytest
import torch

from attentiondm_tpu_torch.models.unet import UNetConfig, unet_init
from attentiondm_tpu_torch.tools import quality_protocol as qp
from test_torch_quality_protocol import CFG, both_ladders, off_band, same_order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_rows_match_jax_within_band():
    ours, theirs = both_ladders(bit_configs=((4, 8),), stage2=False, serving=True, bf16=False)
    assert list(ours) == list(theirs) == ["fp32", "w4a8_s1", "int8_w4a8", "int8_w4a8_bf16res"]
    assert not off_band(ours, theirs), (ours, theirs)
    assert same_order(ours, theirs)


def test_gptq_leg_with_stage2_teacher_runs(capsys):
    """`--adaround --weight_rows gptq --stage2_teacher`: the GPTQ rows, the
    teacher-matched fake-quant row and the serving-matched stage 2 on
    AdaRound extras made for it, every row finite; the Gram batch printed;
    rows reported as they land (`on_row`)."""
    cfg = UNetConfig(**dict(CFG, ch=32))
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    landed = []
    rows = qp.run_protocol(params, cfg, steps=2, batch=2, calib_batch=2, bit_configs=((4, 8),), stage2=False,
                           bf16=False, adaround=True, adaround_iters=10, weight_rows="gptq", stage2_teacher=True,
                           on_row=lambda name, row: landed.append(name), device="cpu")
    assert list(rows) == landed == ["fp32", "w4a8_s1", "w4a8_s12t", "int8_w4a8", "int8_w4a8_bf16res",
                                    "int8_w4a8_gptq", "int8_w4a8_gptq_refine", "int8_w4a8_ar_s2srv"]
    assert all(v == v and abs(v) != float("inf") for n, r in rows.items() for k, v in r.items()
               if not (n == "fp32" and k == "psnr"))
    assert "Gram batch: 2 of the 2 calibration images at 16^2\n" in capsys.readouterr().out


@pytest.mark.parametrize("res, want", [(16, 8), (32, 8), (64, 2), (256, 1)])
def test_gram_batch_is_printed(capsys, res, want):
    assert qp.gram_batch(8, res) == want
    out = capsys.readouterr().out
    assert out.startswith(f"Gram batch: {want} of the 8 calibration images at {res}^2")
    assert ("capped" in out) == (want < 8)


def test_ar_leg_with_stage2_teacher_keeps_jax_legs():
    """`--weight_rows ar --stage2_teacher`: the AdaRound rows and no
    serving-matched stage 2 or GPTQ row, as JAX's `continue` leaves them
    (`attentiondm_tpu/tools/quality_protocol.py:503-504`)."""
    cfg = UNetConfig(**dict(CFG, ch=32))
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rows = qp.run_protocol(params, cfg, steps=2, batch=2, calib_batch=2, bit_configs=((4, 8),), stage2=False,
                           bf16=False, adaround=True, adaround_iters=10, weight_rows="ar", stage2_teacher=True,
                           shared=True, device="cpu")
    assert list(rows) == ["fp32", "w4a8_s1", "w4a8_s12t", "int8_w4a8", "int8_w4a8_bf16res", "int8_w4a8_bc",
                          "int8_w4a8_ar", "int8_w4a8_ar_bf16res", "int8_w4a8_ar_refine",
                          "int8_w4a8_ar_refine_bf16res"]
