"""The port's PNG codec (``ever_tpu_torch/data/_png.py``) against PIL, which
the JAX package's readers decode with: files PIL writes (with its adaptive
row filters) and files written with each of the five filters decode to
``np.asarray(Image.open(path))`` exactly; PIL reads the port's files back
exactly; what the decoder does not read raises an error naming the file.
PIL is the independent check here; the port never imports it."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ever_tpu_torch.data._png import png_size, read_png, write_png

MODES = {'L': (), 'LA': (2,), 'RGB': (3,), 'RGBA': (4,)}


def _image(rng, h, w, mode):
    """Smooth ramps plus noise: PIL's adaptive filtering then picks
    different filters on different rows."""
    shape = (h, w) + MODES[mode]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * yy + 5 * xx).reshape((h, w) + (1,) * len(MODES[mode]))
    noise = rng.integers(0, 24, size=shape)
    return ((base + noise) % 256).astype(np.uint8)


def _filters_used(path):
    """The filter byte of every row of a PNG file (bit depth 8)."""
    with open(path, 'rb') as f:
        data = f.read()
    pos, idat, hdr = 8, b'', None
    while pos < len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', payload)
        elif kind == b'IDAT':
            idat += payload
        pos += 12 + length
    width, height, _, color = hdr[:4]
    stride = width * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(height)}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_files_pil_writes_decode_exactly(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    img = _image(rng, 67, 45, mode)
    path = str(tmp_path / f'{mode}.png')
    Image.fromarray(img, mode).save(path)
    got, want = read_png(path), np.asarray(Image.open(path))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert png_size(path) == img.shape[:2]


def test_pil_adaptive_filters_use_several_types(tmp_path):
    path = str(tmp_path / 'rgb.png')
    Image.fromarray(_image(np.random.default_rng(0), 96, 80, 'RGB')).save(path)
    assert len(_filters_used(path)) >= 2


def test_palette_file_decodes_to_its_indices(tmp_path):
    """A palette (P) image gives the index array, as np.asarray of PIL's
    image does, not colours."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 256, size=(31, 29), dtype=np.uint8)
    im = Image.fromarray(idx, 'P')
    im.putpalette(rng.integers(0, 256, size=768, dtype=np.uint8).tolist())
    path = str(tmp_path / 'p.png')
    im.save(path)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(want, idx)
    got = read_png(path)
    assert got.shape == (31, 29)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('filter_type', range(5))
@pytest.mark.parametrize('mode', ['L', 'LA', 'RGB', 'RGBA'])
def test_each_filter_round_trips_and_pil_reads_it(filter_type, mode, tmp_path):
    img = _image(np.random.default_rng(filter_type), 23, 37, mode)
    path = str(tmp_path / 'f.png')
    write_png(path, img, filter_type=filter_type)
    assert _filters_used(path) == {filter_type}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_mixed_filters_decode(tmp_path):
    """One file whose rows cycle through the five filters (each row
    filtered against the row above it unfiltered), against PIL."""
    img = _image(np.random.default_rng(9), 40, 33, 'RGB')
    rows = []
    for y in range(img.shape[0]):
        one = np.zeros_like(img[:2])
        one[1] = img[y]
        if y:
            one[0] = img[y - 1]
        ft = y % 5
        path = str(tmp_path / 'row.png')
        write_png(path, one, filter_type=ft)
        with open(path, 'rb') as f:
            data = f.read()
        length = struct.unpack('>I', data[33:37])[0]
        raw = zlib.decompress(data[41:41 + length])
        rows.append(raw[len(raw) // 2:])           # the second row, filter byte first
    body = zlib.compress(b''.join(rows))
    hdr = struct.pack('>IIBBBBB', img.shape[1], img.shape[0], 8, 2, 0, 0, 0)

    def chunk(kind, payload):
        return (struct.pack('>I', len(payload)) + kind + payload
                + struct.pack('>I', zlib.crc32(kind + payload)))
    path = str(tmp_path / 'mixed.png')
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', hdr) + chunk(b'IDAT', body)
                + chunk(b'IEND', b''))
    assert _filters_used(path) == set(range(5))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    rng = np.random.default_rng(1)
    deep = str(tmp_path / 'deep.png')
    Image.fromarray(rng.integers(0, 65535, size=(8, 8), dtype=np.uint16)).save(deep)
    with pytest.raises(ValueError, match='deep.png.*bit depth 16'):
        read_png(deep)
    interlaced = str(tmp_path / 'adam7.png')
    good = str(tmp_path / 'good.png')
    write_png(good, rng.integers(0, 256, size=(9, 7, 3), dtype=np.uint8))
    with open(good, 'rb') as f:
        data = bytearray(f.read())
    data[28] = 1                                     # IHDR interlace byte
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29])))
    with open(interlaced, 'wb') as f:
        f.write(data)
    with pytest.raises(ValueError, match='adam7.png.*interlaced'):
        read_png(interlaced)
    bad = str(tmp_path / 'badcrc.png')
    with open(good, 'rb') as f:
        data = bytearray(f.read())
    data[-20] ^= 0xFF                                # a byte of the IDAT payload
    with open(bad, 'wb') as f:
        f.write(data)
    with pytest.raises(ValueError, match='badcrc.png.*CRC'):
        read_png(bad)
    with pytest.raises(ValueError, match='uint8'):
        write_png(str(tmp_path / 'x.png'), np.zeros((2, 2), np.float32))
