"""PyTorch port vs the JAX package: the quality ladder's stage-2 rows
(`run_protocol(stage2=True)`: w4a8_s12, the attention-focused selection,
and w4a8_s12g, all convs), on tests/test_torch_quality_protocol.py's toy,
draws and bands, JAX's stage-2 noise handed in (`stage2_noise`).  One bit
config (4:8): each stage-2 run compiles a value-and-grad scan in JAX, and
the W8A8 rows' stage 1 is held in test_torch_quality_protocol.py."""
import pytest
import torch

from test_torch_quality_protocol import both_ladders, off_band, same_order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ladders():
    return both_ladders(bit_configs=((4, 8),), stage2=True, serving=False, bf16=False)


def test_stage2_rows_match_jax_within_band(ladders):
    ours, theirs = ladders
    assert list(ours) == list(theirs) == ["fp32", "w4a8_s1", "w4a8_s12", "w4a8_s12g"]
    assert not off_band(ours, theirs), (ours, theirs)
    assert same_order(ours, theirs)


def test_stage2_moves_the_states(ladders):
    """The stage-2 rows are their own runs: each differs from stage 1's."""
    ours, _ = ladders
    s1 = ours["w4a8_s1"]["eps_rel_mse_mean"]
    assert ours["w4a8_s12"]["eps_rel_mse_mean"] != s1 and ours["w4a8_s12g"]["eps_rel_mse_mean"] != s1
