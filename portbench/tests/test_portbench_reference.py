"""The plain reference against the port's plain sampler at the toy size on
the CPU (this test imports the port; the reference does not)."""
import json

import torch

from portbench.harness import params as P
from portbench.harness import program as PR
from portbench.harness.check import BlockCheck, Subject, block_gaps, fold_gap, image_gaps
from portbench.reference import ddpm_w4a8 as ref

from .conftest import ROOT, add_toy


def test_reference_agrees_with_the_ports_plain_path(bench_copy):
    torch.set_num_threads(2)
    add_toy(bench_copy)
    cfg = json.loads((bench_copy / "portbench/configs/toy.json").read_text())
    mix = json.loads((bench_copy / "portbench/traffic/toy-mix.json").read_text())
    dev = torch.device("cpu")
    params = P.draw_params(ref.param_layout(cfg), P.seeded(3, 0, dev), dev)
    x_cal = torch.randn((2, 16, 16, 3), generator=P.seeded(3, 1, dev))
    x = torch.randn((4, 16, 16, 3), generator=P.seeded(3, 2, dev))
    prog = PR.Program(cfg, mix, dev)
    xs = prog.teacher(params, x_cal)
    qstates = prog.calibrate(params, xs)
    sample = prog.sampler(params, qstates)
    ranges = PR.Program.ranges(qstates)
    sched = ref.schedule(cfg, mix["timesteps"], mix["skip_type"], dev)

    # the float UNet and DDIM: the teacher's trajectory to float32 rounding
    xs_ref = ref.teacher_inputs(params, cfg, x_cal, sched)
    assert ((xs - xs_ref).abs().max() / xs_ref.abs().max()) < 1e-5
    # stage 1 at the first sites, before any quantizer's rounding can compound
    rr = ref.calibrate(params, cfg, xs_ref, sched)
    for name in ("conv_in", "down.0.block.0.conv1"):
        assert torch.allclose(rr[name], ranges[name], rtol=1e-5, atol=1e-5)
    # the fold of the same ranges: the same codes, the epilogues to float32 rounding
    subject = Subject(xs, ranges, lambda n, s, shape: PR.Program.fold_step(sample.runtime, n, s, shape), None, None)
    assert fold_gap(ref, cfg, params, subject) < 1e-5
    # the served sampler on the same ranges: each block on the port's own input to float32 rounding, but for
    # the rare int8 code that the rounding flips; the whole within the int8 chain's rounding spread
    blocks = BlockCheck(ref, cfg, params, ranges, sched)
    with PR.Blocks(blocks):
        out = sample(x)
    assert len(blocks.gaps) == 3 * 12 and block_gaps(blocks.gaps)[1] < 1e-4
    folds = ref.fold(params, cfg, ranges)
    assert max(image_gaps(out, ref.serve(params, cfg, folds, ranges, sched, x))) < 0.03
