"""The port's image files, resizing and polygons (``mars_tpu_torch.data.
image_io``, ``native/image_codecs.cpp``) against Pillow 12.1.0 on
libjpeg-turbo 3.1.3, and its CLIP tokenizer without ``regex``.

Bit for bit: the committed fixtures (``tests/fixtures/images``, their
digests in ``expected.json``) and files Pillow writes from hypothesis'
draws (JPEG at every subsampling, progressive, optimised, with restart
markers, grayscale and CMYK; PNG in every colour type and bit depth the
port reads, every row filter); NEAREST / BILINEAR resizes at sizes 1-700;
polygon fills with float, outside and self-intersecting points.  The
formats the port does not read raise, naming what they met.  The five
benchmark layouts of ``tests/real_layouts`` give records equal to the JAX
loaders'.
"""
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image, ImageDraw

import real_layouts as rl
from mars_tpu.data import build_dataset as jbuild
from mars_tpu.data.base import episode_host_u8 as jhost
from mars_tpu.text import tokenizer as jtok
from mars_tpu_torch.data import image_io
from mars_tpu_torch.data.base import episode_host_u8 as thost
from mars_tpu_torch.data.registry import build_dataset as tbuild
from mars_tpu_torch.text import tokenizer as ttok
from test_torch_data import assert_same_record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = rl.expected()
FEW = settings(max_examples=40, deadline=None, database=None)


def same(got, want) -> bool:
    """Equal values, type, shape and bytes (Pillow's bool arrays hold 255)."""
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def pil_read(data: bytes, mode=None) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    return np.array(im if mode is None else im.convert(mode))


def port_read(data: bytes, mode=None) -> np.ndarray:
    with tempfile.NamedTemporaryFile() as f:
        f.write(data)
        f.flush()
        return image_io.read_image(f.name, mode)


# ---------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(EXPECTED["files"]))
def test_fixture_decodes_and_resizes_as_pil(name):
    path = os.path.join(rl.FIXTURES, name)
    want = EXPECTED["files"][name]
    with open(path, "rb") as f:
        data = f.read()
    for key, mode in (("none", None), ("RGB", "RGB"), ("L", "L")):
        got = image_io.read_image(path, mode)
        assert rl.array_sha(got) == want["decode"][key], (name, key)
        assert same(got, pil_read(data, mode)), (name, key)
    rgb, gray = image_io.read_image(path, "RGB"), image_io.read_image(path, "L")
    for key, img, resample in (("bilinear_RGB", rgb, image_io.BILINEAR),
                               ("nearest_L", gray, image_io.NEAREST)):
        got = image_io.resize(img, rl.SIZE, rl.SIZE, resample)
        assert rl.array_sha(got) == want["resize518"][key], (name, key)
        pil = Image.fromarray(img).resize((rl.SIZE, rl.SIZE), resample)
        assert same(got, np.array(pil)), (name, key)


def test_fixture_polygons_equal_expected():
    for p in EXPECTED["polygons"]:
        got = image_io.polygon_mask(p["polygons"], p["h"], p["w"])
        assert rl.array_sha(got)["sha256"] == p["sha256"], p["polygons"]


# ---------------------------------------------------------------- JPEG
def scene(seed: int, h: int, w: int, channels: int) -> np.ndarray:
    """Gradients, a block and grain: what a JPEG of a photo codes."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = rng.uniform(0, 255, channels) + (x[..., None] * rng.uniform(-4, 4, channels)
                                           + y[..., None] * rng.uniform(-4, 4, channels))
    img[h // 4: h // 2 + 1, w // 3: w // 2 + 1] = rng.uniform(0, 255, channels)
    img += rng.normal(0, rng.uniform(0, 30), img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(seed, h, w, mode, **kw) -> bytes:
    px = scene(seed, h, w, {"L": 1, "RGB": 3, "CMYK": 4}[mode])
    im = Image.fromarray(px[..., 0] if mode == "L" else px, mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


@FEW
@given(seed=st.integers(0, 2 ** 31 - 1), h=st.integers(1, 70), w=st.integers(1, 70),
       mode=st.sampled_from(["RGB", "L", "CMYK"]), quality=st.integers(1, 100),
       subsampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(),
       optimize=st.booleans(), restart=st.integers(0, 4))
def test_jpeg_equals_pil(seed, h, w, mode, quality, subsampling, progressive, optimize, restart):
    kw = {"quality": quality, "subsampling": subsampling, "progressive": progressive,
          "optimize": optimize}
    if restart:
        kw["restart_marker_blocks"] = restart
    data = jpeg_bytes(seed, h, w, mode, **kw)
    for m in (None, "RGB", "L"):
        assert same(port_read(data, m), pil_read(data, m)), (kw, m)


def _sof(data: bytes) -> int:
    return next(i for i in range(2, len(data) - 1)
                if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))


@pytest.mark.parametrize("marker,message", [(0xC3, "lossless"), (0xC5, "hierarchical"),
                                            (0xC7, "hierarchical"), (0xC9, "arithmetic"),
                                            (0xCA, "arithmetic"), (0xCD, "arithmetic")])
def test_unsupported_jpeg_frames_raise(marker, message):
    data = bytearray(jpeg_bytes(1, 20, 30, "RGB"))
    data[_sof(data) + 1] = marker
    with pytest.raises(ValueError, match=f"{message}.*0xFF{marker:02X}"):
        port_read(bytes(data))


def test_twelve_bit_jpeg_raises():
    data = bytearray(jpeg_bytes(2, 20, 30, "L"))
    data[_sof(data) + 4] = 12  # the frame's sample precision
    with pytest.raises(ValueError, match="12-bit"):
        port_read(bytes(data))


@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_jpeg_raises_as_pil_does(progressive):
    data = jpeg_bytes(3, 48, 64, "RGB", progressive=progressive, quality=90)
    sos = data.index(b"\xff\xda")
    for cut in (sos + 40, (sos + len(data)) // 2, len(data) - 10):
        part = data[:cut]
        with pytest.raises(OSError):
            pil_read(part)
        with pytest.raises(ValueError, match="truncated"):
            port_read(part)


# ---------------------------------------------------------------- PNG
def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG's five row filters, one chosen per row."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r, f in zip(rows.astype(np.int32), filters):
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[: len(r)]
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[: len(r)]
        b = prev
        if f == 0:
            v = r
        elif f == 1:
            v = r - a
        elif f == 2:
            v = r - b
        elif f == 3:
            v = r - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            v = r - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + (v & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_bytes(vals, ctype, depth, filters, palette=None, trns=None, interlace=0, idat_parts=1):
    """A PNG written here: any colour type and depth, the given row filters."""
    h, w = vals.shape[:2]
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    flat = vals.reshape(h, w * samples).astype(np.uint8)
    if depth < 8:
        per = 8 // depth
        packed = np.zeros((h, (w * depth + 7) // 8), np.uint8)
        for i in range(w):
            packed[:, i // per] |= (flat[:, i] << (8 - depth - depth * (i % per))).astype(np.uint8)
        flat = packed
    raw = zlib.compress(_filter_rows(flat, max(1, samples * depth // 8), filters))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                                0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    step = -(-len(raw) // idat_parts)
    for i in range(0, len(raw), step):
        data += _chunk(b"IDAT", raw[i:i + step])
    return data + _chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
             (6, 8)]


@FEW
@given(kind=st.sampled_from(PNG_KINDS), h=st.integers(1, 40), w=st.integers(1, 40),
       seed=st.integers(0, 2 ** 31 - 1), parts=st.integers(1, 3))
def test_png_equals_pil(kind, h, w, seed, parts):
    ctype, depth = kind
    rng = np.random.RandomState(seed)
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    vals = rng.randint(0, 1 << depth, (h, w, samples))
    palette = trns = None
    if ctype == 3:
        palette = rng.randint(0, 256, (rng.randint(1, 257), 3)).astype(np.uint8)
        if rng.rand() < 0.5:  # a palette shorter than the indices: Pillow's black
            vals = np.minimum(vals, len(palette) + 2)
        if rng.rand() < 0.3:
            trns = bytes(rng.randint(0, 256, rng.randint(1, len(palette) + 1)).astype(np.uint8))
    elif ctype == 0 and rng.rand() < 0.3:
        trns = struct.pack(">H", int(rng.randint(0, 1 << depth)))
    data = png_bytes(vals, ctype, depth, rng.randint(0, 5, h), palette, trns, idat_parts=parts)
    for m in (None, "RGB", "L"):
        assert same(port_read(data, m), pil_read(data, m)), (kind, m)


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGB", "RGBA"])
def test_pil_written_png_equals_pil(mode):
    rng = np.random.RandomState(5)
    px = rng.randint(0, 256, (23, 31, 4)).astype(np.uint8)
    im = Image.fromarray(px, "RGBA").convert(mode)
    for kw in ({}, {"optimize": True}, {"bits": 4} if mode == "P" else {"compress_level": 1}):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        for m in (None, "RGB", "L"):
            assert same(port_read(buf.getvalue(), m), pil_read(buf.getvalue(), m)), (kw, m)


def test_unsupported_pngs_and_formats_raise():
    vals = np.zeros((4, 5, 1), np.uint8)
    with pytest.raises(ValueError, match="Adam7"):
        port_read(png_bytes(vals, 0, 8, [0] * 4, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000).save(buf, "PNG")
    with pytest.raises(ValueError, match="16-bit"):
        port_read(buf.getvalue())
    broken = bytearray(png_bytes(vals, 0, 8, [0] * 4))
    broken[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC|truncated"):
        port_read(bytes(broken))
    buf = io.BytesIO()
    Image.fromarray(vals[..., 0]).save(buf, "GIF")
    with pytest.raises(ValueError, match="GIF8"):
        port_read(buf.getvalue())


# ---------------------------------------------------------------- resize
@FEW
@given(h=st.integers(1, 700), w=st.integers(1, 700), oh=st.integers(1, 700),
       ow=st.integers(1, 700), rgb=st.booleans(), seed=st.integers(0, 2 ** 31 - 1),
       resample=st.sampled_from([image_io.NEAREST, image_io.BILINEAR]))
def test_resize_equals_pil(h, w, oh, ow, rgb, seed, resample):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3) if rgb else (h, w)).astype(
        np.uint8)
    want = np.array(Image.fromarray(img).resize((ow, oh), resample))
    assert same(image_io.resize(img, ow, oh, resample), want)


# ---------------------------------------------------------------- polygons
coord = st.one_of(st.integers(-20, 80).map(float),
                  st.floats(-20, 80, allow_nan=False).map(lambda v: round(v, 2)),
                  st.floats(-20, 80, allow_nan=False))
polygons = st.lists(st.lists(coord, min_size=6, max_size=24), min_size=1, max_size=3)


def pil_polygons(polys, h, w):
    im = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(im)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.array(im)


@settings(max_examples=300, deadline=None, database=None)
@given(polys=polygons, h=st.integers(1, 64), w=st.integers(1, 64))
def test_polygon_fill_equals_pil(polys, h, w):
    assert same(image_io.polygon_mask(polys, h, w), pil_polygons(polys, h, w))


# ---------------------------------------------------------------- layouts
@pytest.fixture(scope="module")
def layouts():
    with tempfile.TemporaryDirectory() as tmp:
        roots = [os.path.join(tmp, "jax"), os.path.join(tmp, "port")]
        for root in roots:
            rl.lay_out_all(root)
        yield roots


@pytest.mark.parametrize("benchmark", rl.BENCHMARKS)
def test_real_layouts_equal_jax_loaders(benchmark, layouts):
    """The port's loaders on the committed files against the JAX loaders
    (Pillow underneath) and ``expected.json``: records and
    ``episode_host_u8`` arrays bit for bit."""
    jds = jbuild(benchmark, layouts[0], 0, "test", 1, rl.SEED)
    tds = tbuild(benchmark, layouts[1], 0, "test", 1, rl.SEED)
    for idx, want in enumerate(EXPECTED["layouts"][benchmark]["episodes"]):
        got, ref = tds[idx], jds[idx]
        assert_same_record(got, ref, layouts)
        assert rl.record_digest(got) == want["record"], (benchmark, idx)
        host = thost(got, rl.SIZE, 1)
        for a, b in zip(host, jhost(ref, rl.SIZE, 1)):
            assert same(a, b), (benchmark, idx)
        assert rl.arrays_digest(host) == want["host_u8"], (benchmark, idx)


# ---------------------------------------------------------------- tokenizer
_PORT_IDS = """
import json, sys
sys.modules["regex"] = None  # as on the card's machine
from mars_tpu_torch.text import tokenizer
texts = json.load(sys.stdin)
print(json.dumps(tokenizer.tokenize(texts).tolist()))
print(sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] == "regex"))
"""
SPECIAL = ["a photo of a jalapeño", "a naïve café", "crème brûlée", "It's Ǆ 'S 'ſ <|ſtartoftext|>",
           "x\x1cy z　w ͅ٣۴ ½", "<|startoftext|>hi<|endoftext|>", "", "   ", "&amp;lt;3"]


def test_tokenizer_without_regex_equals_jax():
    """Hypothesis' texts (any code point: letters and numbers outside
    ASCII, whitespace, marks) through the port in a process where ``regex``
    cannot be imported, against the JAX tokenizer with ``regex``."""
    texts = list(SPECIAL)

    @settings(max_examples=300, deadline=None, database=None)
    @given(st.text(max_size=40))
    def draw(t):
        texts.append(t)

    draw()
    texts = [t for t in texts if not any(0xD800 <= ord(c) < 0xE000 for c in t)]
    r = subprocess.run([sys.executable, "-c", _PORT_IDS], input=json.dumps(texts),
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    ids, loaded = r.stdout.splitlines()
    assert loaded == "[]"
    got = np.asarray(json.loads(ids))
    want = jtok.tokenize(texts)
    bad = [t for t, g, w in zip(texts, got, want) if not np.array_equal(g, w)]
    assert not bad, bad[:5]
    assert got[0][:7].tolist() == [49406, 320, 1125, 539, 320, 43017, 49407]


def test_char_classes_equal_regex():
    """The committed table against ``regex``'s classes of every code point."""
    import regex

    chars = "".join(chr(c) for c in range(0x110000))
    classes = {"L": r"(?i)[\p{L}]", "N": r"(?i)[\p{N}]", "O": r"(?i)[^\s\p{L}\p{N}]", "S": r"\s"}
    want = {k: {ord(c) for c in regex.findall(p, chars)} for k, p in classes.items()}
    runs = ttok._classes
    assert runs.REGEX_VERSION == regex.__version__
    starts = list(runs.STARTS) + [0x110000]
    for k, cls in enumerate(runs.CLASSES):
        span = range(starts[k], starts[k + 1])
        for name, members in want.items():
            inside = sum(1 for c in span if c in members)
            assert inside == (len(span) if name == cls else 0), (hex(starts[k]), cls, name)
    assert ttok._class("ͅ") == "X"
