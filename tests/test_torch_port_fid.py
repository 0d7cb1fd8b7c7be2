"""Port parity of the FID scorer against the JAX package, on the CPU.

Random torchvision-layout Inception weights at 1/8 of the published widths
(every width but the input's divided by 8), drawn from numpy: kaiming
convolutions and BatchNorm statistics near identity, with positive
variances, so the features depend on the input.

* pool3 features of 256 px images (where both packages' resizes agree)
  within 1e-5 of their scale (17 float32 convolution stages summed in
  another order); ``convert_inception``'s tree equal to JAX's bit for bit;
  ``bridge.load_inception`` the same module as the state dict's.
* ``frechet_distance``: JAX's number, bit for bit (the same scipy calls).
* JAX fault (i): at 512 px JAX's ``preprocess`` antialiases and differs
  from pytorch-fid's ``F.interpolate(bilinear, align_corners=False)`` by
  more than 0.1; the port's equals it.
* The CLI with ``--device cpu``: ``--save_stats`` writes JAX's statistics
  of the directory (within 1e-5 of their scale), the ``.npz`` reads back,
  and the printed FIDs agree with JAX's within 1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from wmar_tpu.eval import fid as jfid  # noqa: E402
from wmar_tpu_torch import bridge  # noqa: E402
from wmar_tpu_torch.eval import fid as tfid  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the fast tier runs six test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIV = 8
FEAT_REL = 1e-5
FID_REL = 1e-3


def _random_sd(div=DIV, seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    for k, s in tfid.inception_state_dict_shapes(div).items():
        if k.endswith("conv.weight"):
            sd[k] = (rng.standard_normal(s) * (2.0 / np.prod(s[1:])) ** 0.5).astype(np.float32)
        elif k.endswith(("running_var", "bn.weight")):
            sd[k] = rng.uniform(0.8, 1.2, s).astype(np.float32)
        else:
            sd[k] = rng.uniform(-0.1, 0.1, s).astype(np.float32)
    return sd


def _images(n, size, seed):
    """Smooth images that differ from one another (random colour ramps and
    blobs): iid noise would give every image the same pool3 average."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(-1, 1, (3, 3))
        cy, cx, r = rng.uniform(0.2, 0.8, 3)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (0.05 + 0.2 * r))
        img = 0.5 + 0.25 * (a[:, None, None] * xx + b[:, None, None] * yy + c[:, None, None] * blob)
        out.append(np.clip(img.transpose(1, 2, 0), 0, 1))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    sd = _random_sd()
    return sd, tfid.FIDInceptionV3.from_state_dict(sd)


def test_shapes_are_torchvision_inception_v3():
    """At full width: torchvision's inception_v3 has 27,161,264 parameters,
    3,326,696 of them in AuxLogits and 2,049,000 in its 1000-way fc; the
    FID net has a 1008-way fc and no aux head."""
    shapes = tfid.inception_state_dict_shapes()
    n = sum(int(np.prod(s)) for k, s in shapes.items() if not k.endswith(("running_mean", "running_var")))
    assert n == 27_161_264 - 3_326_696 - 2_049_000 + 1008 * 2049
    assert shapes["Mixed_7c.branch3x3dbl_1.conv.weight"] == (448, 2048, 1, 1)
    assert shapes["Mixed_6e.branch7x7dbl_5.conv.weight"] == (192, 192, 1, 7)
    model = tfid.FIDInceptionV3.from_state_dict(
        {k: torch.zeros(s) for k, s in tfid.inception_state_dict_shapes(DIV).items()})
    assert model(torch.zeros((1, 3, 80, 80))).shape == (1, 2048 // DIV)
    with pytest.raises(KeyError):
        tfid.FIDInceptionV3.from_state_dict({k: v for k, v in _random_sd().items() if "Mixed_6b.branch1x1.bn" not in k})


def test_pool3_matches_jax_at_256px(weights):
    sd, model = weights
    x = _images(4, 256, 1)
    params = jax.tree.map(jnp.asarray, jfid.convert_inception(sd))
    want = np.asarray(jax.jit(lambda p, x: jfid.inception_pool3(p, jfid.preprocess(x)))(params, jnp.asarray(x)))
    got = tfid.compute_activations(model, x, batch_size=3)
    assert got.shape == want.shape == (4, 2048 // DIV)
    assert want.std(axis=0).mean() > 1e-3 * np.abs(want).max()  # the features depend on the image
    assert np.abs(got - want).max() <= FEAT_REL * np.abs(want).max()
    tree = tfid.convert_inception(sd)
    jtree = jfid.convert_inception(sd)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)))
    same = bridge.load_inception(jtree)
    assert all(torch.equal(a, b) for a, b in zip(same.state_dict().values(), model.state_dict().values()))


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((40, 16)), rng.standard_normal((30, 16)) * 1.3 + 0.2
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    got = tfid.frechet_distance(*stats[0], *stats[1])
    assert got == jfid.frechet_distance(*stats[0], *stats[1]) and got > 0
    assert abs(tfid.frechet_distance(*stats[0], *stats[0])) < 1e-9


def test_fault_i_jax_fid_resize_antialiases_at_512():
    """At 512 px (Chameleon's images) JAX's ``jax.image.resize(bilinear)``
    antialiases the shrink to 299 and departs from pytorch-fid's resize by
    more than 0.1; the port's resize is pytorch-fid's. At 256 px (a stretch)
    the two agree."""
    for size, jax_apart in ((512, True), (256, False)):
        imgs = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
        ref = 2 * F.interpolate(torch.from_numpy(imgs).permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                                align_corners=False) - 1
        port = tfid.preprocess(torch.from_numpy(imgs))
        jaxs = torch.from_numpy(np.asarray(jfid.preprocess(jnp.asarray(imgs)))).permute(0, 3, 1, 2)
        assert torch.equal(port, ref)
        assert ((jaxs - ref).abs().max() > 0.1) == jax_apart
        if not jax_apart:
            assert (jaxs - ref).abs().max() < 1e-6


def test_cli_on_the_cpu(tmp_path, weights, capsys):
    from PIL import Image

    sd, _ = weights
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "incep.pth")
    dirs = []
    for name, seed in (("a", 3), ("b", 4)):
        d = tmp_path / name
        os.makedirs(d / "sub")
        for i, img in enumerate(_images(6, 256, seed)):
            Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(d / ("sub" if i % 2 else "") / f"{i:02}.png")
        dirs.append(str(d))
    base = ["--weights", str(tmp_path / "incep.pth"), "--device", "cpu", "--batch_size", "4"]
    stats = str(tmp_path / "a.npz")
    assert tfid.main([dirs[0], dirs[1], *base, "--save_stats", stats]) == 0
    assert tfid.main([dirs[0], dirs[1], *base]) == 0
    assert tfid.main([stats, dirs[1], *base]) == 0
    assert tfid.main([dirs[0], dirs[1], *base, "--limit", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"saved stats to {stats}"
    fids = [float(line.split("FID: ")[1]) for line in out[1:]]
    assert fids[0] == fids[1] > 0 and fids[2] != fids[0]
    params = jax.tree.map(jnp.asarray, jfid.convert_inception(sd))
    jstats = [jfid.compute_statistics(params, jfid._load_images(d), batch_size=4) for d in dirs]
    z = np.load(stats)
    assert np.abs(z["mu"] - jstats[0][0]).max() <= FEAT_REL * np.abs(jstats[0][0]).max()
    assert np.abs(z["sigma"] - jstats[0][1]).max() <= 1e-4 * np.abs(jstats[0][1]).max()
    assert fids[0] == pytest.approx(jfid.frechet_distance(*jstats[0], *jstats[1]), rel=FID_REL)
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(SystemExit, match="no CUDA"):
            tfid.main([dirs[0], dirs[1], "--weights", str(tmp_path / "incep.pth")])
