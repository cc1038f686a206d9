"""The port's figures (``utils.visualize``): numpy panels in a PNG written
with zlib.  Every panel's pixels are its input's rendering, a standard
decoder (Pillow) reads the file as ``read_png`` does, the title and panel
names ride in tEXt chunks, and ``cli_proposals --visualize`` names its
figures as the JAX CLI does (``test_torch_rle``, with --use-centers;
``test_torch_fold_loop`` for the ranking CLI, whose meter trace stays as
it is)."""
import json

import numpy as np
import pytest
import torch

from mars_tpu_torch.utils import visualize


def _inputs(seed=0, h=50, w=60):
    rng = np.random.RandomState(seed)
    props = rng.rand(6, h, w) > 0.6
    return dict(query_img=rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                support_img=rng.rand(h, w, 3).astype(np.float32),
                support_mask=rng.rand(h, w) > 0.5,
                points=np.array([[5, 7], [30, 40], [59, 49], [0, 0]], np.float32),
                point_valid=np.array([True, True, True, False]),
                vva=rng.rand(7, 7), vta=rng.rand(7, 7) * 3 - 1, proposals=props,
                proposal_valid=np.array([True, False, True, True, True, True]),
                scores=np.array([0.3, 0.9, 0.8, 0.1, 0.5, 0.5], np.float32),
                merged=props[2].astype(np.float32), gt=rng.rand(h, w) > 0.5)


def test_panels_are_the_inputs_rendering(tmp_path):
    inp = _inputs()
    path = visualize.plot_episode(str(tmp_path / "viz" / "ep00003.png"), title="episode 3",
                                  **inp)
    rgb, text = visualize.read_png(path)
    names = json.loads(text["Panels"])
    # the best four by score, the invalid row 1 (0.9) left out; ties stable
    assert names == ["support", "query + points", "VVA prior", "VTA prior", "prop#2 s=0.80",
                     "prop#4 s=0.50", "prop#5 s=0.50", "merged", "gt"]
    lay = json.loads(text["Layout"])
    assert (lay["cols"], lay["rows"]) == (5, 2) and text["Title"] == "episode 3"
    t = lay["tile"]
    pts = inp["points"][inp["point_valid"]]
    want = [visualize.panel_image(inp["support_img"], inp["support_mask"]),
            visualize.panel_image(inp["query_img"], points=pts),
            visualize.panel_image(inp["vva"]), visualize.panel_image(inp["vta"]),
            *[visualize.panel_image(inp["proposals"][i]) for i in (2, 4, 5)],
            visualize.panel_image(inp["merged"]), visualize.panel_image(inp["gt"])]
    covered = np.zeros(rgb.shape[:2], bool)
    for i, panel in enumerate(want):
        y0, x0 = visualize.panel_box(i, lay)
        np.testing.assert_array_equal(rgb[y0:y0 + t, x0:x0 + t], panel, err_msg=names[i])
        covered[y0:y0 + t, x0:x0 + t] = True
    assert (rgb[~covered] == visualize.BACKGROUND).all()
    # the query panel: its own pixels, but for the crosses at the three valid points
    q = visualize.panel_image(inp["query_img"])
    cross = (want[1] != q).any(axis=-1)
    assert (want[1][cross] == visualize.POINT_COLOR).all() and 3 <= cross.sum() <= 3 * 9


def test_panel_rendering_rules():
    ramp = np.linspace(0, 1, 256).reshape(16, 16)
    got = visualize.panel_image(ramp, tile=16)
    np.testing.assert_array_equal(got.reshape(-1, 3), visualize.COLOR_TABLE)
    np.testing.assert_array_equal(visualize.panel_image(np.full((4, 4), 7.0), tile=2),
                                  np.broadcast_to(visualize.COLOR_TABLE[0], (2, 2, 3)))
    img = np.full((4, 4, 3), 100, np.uint8)
    over = visualize.panel_image(img, overlay=np.eye(4), tile=4)
    np.testing.assert_array_equal(over[0, 0], (100 * 3 + np.array([103, 0, 13]) * 2 + 2) // 5)
    np.testing.assert_array_equal(over[0, 1], (100 * 3 + np.array([255, 245, 240]) * 2 + 2) // 5)


def test_png_reads_with_a_standard_decoder(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.RandomState(1).randint(0, 256, (13, 17, 3)).astype(np.uint8)
    path = visualize.write_png(str(tmp_path / "x.png"), rgb, {"Title": "a — b", "k": "v"})
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb)
        assert im.info["k"] == "v"
    back, text = visualize.read_png(path)
    np.testing.assert_array_equal(back, rgb)
    assert text == {"Title": "a ? b", "k": "v"}  # Latin-1 only
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 1  # inside IDAT: its CRC fails
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        visualize.read_png(str(tmp_path / "bad.png"))


def test_plot_matcher_state_from_generate_output(tmp_path):
    inp = _inputs(2)
    g = {"points": torch.from_numpy(inp["points"]), "point_valid": torch.tensor(inp["point_valid"]),
         "proposal_masks": torch.from_numpy(inp["proposals"]),
         "proposal_valid": torch.from_numpy(inp["proposal_valid"]),
         "emd_score": torch.from_numpy(inp["scores"]), "merged": torch.from_numpy(inp["merged"])}
    path = visualize.plot_matcher_state(str(tmp_path / "m.png"), inp["query_img"], g, "t")
    _, text = visualize.read_png(path)
    assert json.loads(text["Panels"])[0] == "query + points"
    assert json.loads(text["Panels"])[-1] == "merged"
