"""The port's ResNet trunk (the Matcher's alternative encoder) against
mars_tpu.models.resnet on one torchvision-format state dict, its zoo
loader, and the padding it shares with JAX.

Tolerance: float32 convolutions summed in another order by XLA and by
PyTorch: 1e-5 of the largest feature, and the unit patch features within
1e-5.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import resnet as jresnet
from mars_tpu_torch.models import resnet as tresnet, zoo


def torchvision_sd(cfg, seed=0):
    """A torchvision ResNet state dict (numpy) of ``cfg``'s trunk, with its
    ``fc`` head and BatchNorm counters, random running statistics."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, co, ci, k):
        sd[name] = (rng.randn(co, ci, k, k) * np.sqrt(2.0 / (ci * k * k))).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_var"] = (0.5 + rng.rand(c)).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1.weight", cfg.width, 3, 7)
    bn("bn1", cfg.width)
    cin = cfg.width
    for s, n in enumerate(cfg.layers):
        planes = cfg.width * 2 ** s
        for b in range(n):
            pre = f"layer{s + 1}.{b}"
            conv(pre + ".conv1.weight", planes, cin, 1)
            conv(pre + ".conv2.weight", planes, planes, 3)
            conv(pre + ".conv3.weight", planes * 4, planes, 1)
            for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{pre}.bn{j}", c)
            if b == 0:
                conv(pre + ".downsample.0.weight", planes * 4, cin, 1)
                bn(pre + ".downsample.1", planes * 4)
            cin = planes * 4
    sd["fc.weight"] = rng.randn(10, cin).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


@pytest.mark.parametrize("layers,width,size", [((1, 1, 1, 1), 8, 64), ((2, 1, 2), 8, 70),
                                               ((1, 2), 4, 45)])
def test_forward_and_patch_features_equal_jax(layers, width, size):
    """Even and odd input sizes (XLA's SAME padding takes its odd pixel
    after), two and three blocks a stage."""
    jcfg = jresnet.ResNetConfig(layers=layers, width=width)
    tcfg = tresnet.ResNetConfig(layers=layers, width=width)
    sd = torchvision_sd(jcfg)
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jresnet.forward_features(jresnet.convert_torchvision(sd, jcfg),
                                               jnp.asarray(x), jcfg))
    params = tresnet.convert_torchvision(sd, tcfg)
    got = tresnet.forward_features(params, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tresnet.patch_features(got).numpy(),
                               np.asarray(jresnet.patch_features(jnp.asarray(want))), atol=1e-5)
    np.testing.assert_array_equal(
        tresnet.patch_features(torch.from_numpy(want), l2_normalize=False).numpy(),
        np.asarray(jresnet.patch_features(jnp.asarray(want), l2_normalize=False)))


def test_same_padding_is_jaxs_not_torchvisions():
    """A stride-2 3x3 on an even size pads (0, 1) in XLA's SAME, where
    torchvision pads (1, 1): the port follows the JAX package (ROADMAP
    Queue 3 records the departure from torchvision)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 4, 16, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 4, 4).astype(np.float32))  # HWIO
    got = tresnet._conv({"kernel": w}, x, stride=2)
    xla = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)),
                                     w.permute(3, 2, 0, 1), stride=2)
    tv = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), stride=2, padding=1)
    np.testing.assert_array_equal(got.numpy(), xla.numpy())
    assert got.shape == tv.shape and not torch.allclose(got, tv, atol=1e-3)


def test_build_resnet_loads_torchvision_file(tmp_path, monkeypatch):
    """``{variant}.pth`` in --models-path through the audited conversion
    (fc and the BatchNorm counters unread); without it, seeded random
    weights of the same shapes."""
    monkeypatch.setitem(tresnet.BOTTLENECK_LAYERS, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setattr(tresnet, "ResNetConfig", functools.partial(tresnet.ResNetConfig,
                                                                   width=8))
    cfg = tresnet.ResNetConfig(layers=(1, 1, 1, 1))
    sd = torchvision_sd(cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "resnet_tiny.pth")
    params, got_cfg = zoo.build_resnet(str(tmp_path), "resnet_tiny", device="cpu")
    assert got_cfg == cfg
    want = tresnet.convert_torchvision(sd, cfg)
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32))
    np.testing.assert_array_equal(tresnet.forward_features(params, x, cfg).numpy(),
                                  tresnet.forward_features(want, x, cfg).numpy())
    rand, _ = zoo.build_resnet(None, "resnet_tiny", device="cpu")
    again, _ = zoo.build_resnet(None, "resnet_tiny", device="cpu")
    feat = tresnet.forward_features(rand, x, cfg)
    assert feat.shape == (1, 2, 2, 8 * 8 * 4) and torch.isfinite(feat).all()
    assert torch.equal(feat, tresnet.forward_features(again, x, cfg))  # seeded
    del sd["layer1.0.conv2.weight"]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "resnet_tiny.pth")
    with pytest.raises(KeyError):
        zoo.build_resnet(str(tmp_path), "resnet_tiny", device="cpu")
