"""PyTorch port vs the JAX package: the FID Inception (`eval/inception.py`).

The port's features against JAX's `inception_apply` on one set of seeded
weights (JAX's `inception_init`, carried over by `from_jax_params`), and
against the independent torch oracle (tests/torch_inception_oracle.py, the
pt_inception key layout) through `load_torch_inception`: 2 images at 32^2
and 64^2, max |difference| / max |feature| < 1e-4, the bound
tests/test_inception_oracle.py holds JAX to.  Above 299 JAX's
`jax.image.resize` antialiases; the port's `F.interpolate(antialias=True)`
lands 1.8e-6 from it at 320^2 (held to the same 1e-4), while pytorch-fid's
plain bilinear resize (the oracle's) is 2.8e-3 away at 512^2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.eval.inception import inception_apply as j_inception_apply
from attentiondm_tpu.eval.inception import inception_init as j_inception_init
from attentiondm_tpu_torch.eval import InceptionV3FID, inception_apply, inception_init, load_torch_inception
from attentiondm_tpu_torch.eval.inception import from_jax_params
from torch_inception_oracle import TorchFIDInception, randomize_

REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _images(size, seed=None):
    return np.random.default_rng(size if seed is None else seed).random((2, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's seeded Inception tree (numpy leaves) and the port's copy of it."""
    tree = jax.tree_util.tree_map(np.asarray, j_inception_init(jax.random.PRNGKey(0)))
    return tree, from_jax_params(tree, device="cpu")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The randomized torch oracle and its state dict's path."""
    model = randomize_(TorchFIDInception(), seed=0)
    path = tmp_path_factory.mktemp("incep") / "fake_pt_inception.pth"
    torch.save(model.state_dict(), str(path))
    return model, str(path)


@pytest.mark.parametrize("size", [32, 64, 320])
def test_features_match_jax(jax_params, size):
    """The same weights and images through JAX's network and the port's: the
    resize (antialiased above 299 in both), the BatchNorm form, the pads and
    pools, the mean pool."""
    tree, params = jax_params
    x = _images(size)
    want = np.asarray(j_inception_apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    got = inception_apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    assert _rel(got, want) < REL, f"max rel err {_rel(got, want):.2e} at {size}px"


def test_features_match_jax_no_preprocess(jax_params):
    """The raw 299^2 path (no resize, no rescale): the network alone."""
    tree, params = jax_params
    x = (_images(299, seed=7)[:1] - 0.5) * 2.0
    want = np.asarray(j_inception_apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                        resize_input=False, normalize_input=False))
    got = inception_apply(params, torch.from_numpy(x), resize_input=False, normalize_input=False).numpy()
    assert _rel(got, want) < REL


@pytest.mark.parametrize("size", [32, 64])
def test_features_match_torch_oracle(oracle, size):
    """The oracle's state dict through `load_torch_inception` (by name,
    `weights_only=True`): the module's `extract` against the oracle's forward."""
    model, path = oracle
    x = _images(size)
    net = InceptionV3FID.from_torch(path, device="cpu")
    with torch.no_grad():
        ref = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    got = net.extract(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < REL, f"max rel err {_rel(got, ref):.2e} at {size}px"
    assert torch.equal(net(torch.from_numpy(x)), torch.from_numpy(got))


def test_above_299_antialias_is_jaxs_not_pytorch_fids(oracle):
    """Above 299 the oracle (pytorch-fid's plain bilinear resize) and JAX's
    network part: JAX's resize antialiases, and the port follows JAX
    (test_features_match_jax).  On the oracle's weights the two resizes' features
    differ by 4.1e-4 at 320^2 and 2.8e-3 at 512^2 (max rel)."""
    model, path = oracle
    x = _images(512)
    with torch.no_grad():
        ref = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    got = inception_apply(load_torch_inception(path, device="cpu"), torch.from_numpy(x)).numpy()
    assert _rel(got, ref) > 10 * REL


def test_converter_rejects_missing_keys(tmp_path):
    """A truncated state dict fails loudly instead of keeping random weights."""
    sd = randomize_(TorchFIDInception(), seed=1).state_dict()
    sd.pop("Mixed_7c.branch_pool.conv.weight")
    path = tmp_path / "broken.pth"
    torch.save(sd, str(path))
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.conv.weight"):
        load_torch_inception(str(path), device="cpu")


def test_random_init_is_seeded_he_normal():
    """`random(seed)` is deterministic in the seed; each kernel is He normal
    (std sqrt(2 / fan_in)), BatchNorm the identity; the tree and the module
    hold the same tensors."""
    a, b, c = (InceptionV3FID.random(s, device="cpu") for s in (3, 3, 4))
    pa, pb, pc = a.params, b.params, c.params
    k = pa["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"]  # OIHW [128, 128, 1, 7]
    assert k.shape == (128, 128, 1, 7)
    assert abs(k.std().item() / np.sqrt(2.0 / (7 * 128)) - 1) < 0.02
    assert torch.equal(k, pb["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"])
    assert not torch.equal(k, pc["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"])
    bn = pa["Conv2d_1a_3x3"]["bn"]
    assert torch.equal(bn["scale"], torch.ones(32)) and torch.equal(bn["var"], torch.ones(32))
    tree = inception_init(torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(tree["Mixed_7c"]["branch_pool"]["conv"]["kernel"],
                       pa["Mixed_7c"]["branch_pool"]["conv"]["kernel"])
    f = a.extract(torch.from_numpy(_images(32)))
    assert f.shape == (2, 2048) and torch.isfinite(f).all() and f.std() > 0


def test_load_reads_weights_only(tmp_path):
    """A file whose unpickling would run code is refused (`weights_only=True`)."""
    import collections

    sd = collections.OrderedDict(randomize_(TorchFIDInception(), seed=2).state_dict())
    torch.save({"state_dict": sd, "extra": np.random.default_rng(0)}, str(tmp_path / "x.pth"))
    with pytest.raises(Exception, match="[Ww]eights only"):
        load_torch_inception(str(tmp_path / "x.pth"), device="cpu")
    torch.save({"state_dict": sd}, str(tmp_path / "y.pth"))  # a wrapped state dict loads
    tree = load_torch_inception(str(tmp_path / "y.pth"), device="cpu")
    assert tree["Conv2d_1a_3x3"]["conv"]["kernel"].shape == (32, 3, 3, 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the CUDA device here")
@pytest.mark.parametrize("build", ["random", "from_torch"])
def test_entry_points_default_to_the_card(build, oracle):
    """Without `device=`, the network is built on `default_device()`: with no
    CUDA device that raises instead of falling back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        InceptionV3FID.random() if build == "random" else InceptionV3FID.from_torch(oracle[1])
