"""The strip form of every resize (``parallel/spatial.py``
``Strips.resize_rows``, ``module/ops.py`` ``_strip_resize``) against the
JAX package's ``resize`` (``jax.image.resize``) on the whole tile, on the
CPU.

One job of two gloo ranks (``torch_spatial_resize_ranks.resize_worker``,
which imports no JAX) resizes its 8-row strip of a 16×6 tile under the
strip context, while this process runs ``jax.image.resize`` on the whole
tile and ``jax.vjp`` of it (one jitted call): the JAX package's
``resize`` for nearest, and for bilinear in float64 the
``jax.image.resize`` that it wraps and, with ``align_corners``, its
``_resize_align_corners`` matrices (the JAX package casts to float32, and
places its samples at float32 positions: 1.9e-6 off exact at ×1.5 on 24
rows, 1.8e-6 at ``align_corners`` ×0.5, more than the limit):

- nearest and bilinear (half-pixel, antialiased where it shrinks), growing
  ×2, ×4 and ×1.5 and shrinking ×0.5 and ×0.25; ``align_corners`` ×2 and
  ×0.5; ``downsample_bilinear``'s halving;
- a map whole on every rank (5 rows, and 24) resized to the tile's 16 rows
  by ``bilinear_nchw(..., whole=True)``, growing and shrinking.

Each rank's output against the whole output's rows of its strip, and the
input gradient of ``Σ output·probe`` against ``jax.vjp``'s rows of the
strip (a whole map: the ranks' shares summed against the whole gradient).
Limits: float32 bilinear within 1e-6 absolute (inputs and probes drawn
from N(0, 1)); nearest exactly (small integers, whose sums of gradients
are exact in any order).  The halo a strip reads is the whole weight
matrix's support: no row for nearest, one each side for bilinear growing,
halving and ``align_corners`` ×2, two for the quarter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module.ops import resize as jresize
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401
from torch_spatial_resize_ranks import STRIP_CASES, WHOLE_CASES

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD, TILE = 2, (1, 16, 6, 3)
ATOL = 1e-6
# rows a rank sends a case (its halo rows forward, their gradient back):
# the whole matrix's support, one row each side where bilinear reads past
# a strip, two for the quarter's 8-row kernel, none for nearest
HALO_ROWS = {'bilinear x2': 2, 'bilinear x4': 2, 'bilinear x1.5': 2, 'bilinear x0.5': 2,
             'bilinear x0.25': 4, 'corners x2': 2, 'downsample_bilinear': 2}
ROW_BYTES = TILE[2] * TILE[3] * 4


def _out_shape(scale):
    return TILE[0], int(TILE[1] * scale), int(TILE[2] * scale), TILE[3]


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    """{case: (x, probe)} float32: small integers for nearest, N(0, 1)
    otherwise; a whole map's probe has the tile's rows."""
    rng = np.random.default_rng(23)
    data = {}
    for name, method, scale, _ in STRIP_CASES:
        draw = ((lambda s: rng.integers(-4, 5, s)) if method == 'nearest'
                else (lambda s: rng.normal(size=s)))
        data[name] = tuple(draw(s).astype(np.float32) for s in (TILE, _out_shape(scale)))
    for name, rows in WHOLE_CASES:
        data[name] = (rng.normal(size=(1, rows, TILE[2], TILE[3])).astype(np.float32),
                      rng.normal(size=TILE).astype(np.float32))
    return data


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('spatial_resize')
    torch.save(_inputs(), tmp / 'resize-inputs.pt')
    started = start_ranks('torch_spatial_resize_ranks', 'resize_worker', WORLD, tmp, tmp)
    yield tmp, started
    started.kill()


def _bilinear64(shape):
    """``jax.image.resize``'s half-pixel bilinear (antialiased where it
    shrinks) to ``shape`` rows and columns, on a float64 tile."""
    return lambda t: jax.image.resize(t, t.shape[:1] + tuple(shape) + t.shape[3:], 'bilinear')


def _corners64(shape):
    """The JAX package's ``_resize_align_corners`` (output i samples input
    i·(n_in − 1)/(n_out − 1)) to ``shape``, its matrices in float64."""
    def matrix(n_in, n_out):
        pos = jnp.arange(n_out, dtype=jnp.float64) * (n_in - 1) / (n_out - 1)
        lo = jnp.floor(pos)
        hi = jnp.minimum(lo + 1, n_in - 1)
        cols = jnp.arange(n_in, dtype=jnp.float64)[None]
        frac = (pos - lo)[:, None]
        return (cols == lo[:, None]) * (1 - frac) + (cols == hi[:, None]) * frac

    return lambda t: jnp.einsum('oh,pw,nhwc->nopc', matrix(t.shape[1], shape[0]),
                                matrix(t.shape[2], shape[1]), t)


@functools.lru_cache(maxsize=None)
def _jax() -> dict:
    """{case: (output, input gradient)} on the whole tile (a whole map: to
    the tile's rows), one jitted call: nearest by the JAX package's
    ``resize`` in float32, bilinear by ``jax.image.resize`` or the JAX
    package's ``align_corners`` matrices in float64."""
    cases, wide = {}, set()
    for name, method, scale, corners in STRIP_CASES:
        if method == 'bilinear':
            cases[name] = (_corners64 if corners else _bilinear64)(_out_shape(scale)[1:3])
            wide.add(name)
        else:
            cases[name] = lambda t, s=scale: jresize(t, scale=s, method='nearest')
    for name, _ in WHOLE_CASES:
        cases[name], _ = _bilinear64(TILE[1:3]), wide.add(name)

    @jax.jit
    def run(data):
        out = {}
        for name, fn in cases.items():
            y, vjp = jax.vjp(fn, data[name][0])
            out[name] = (y, vjp(data[name][1])[0])
        return out

    with jax.enable_x64(True):
        data = {k: tuple(t.astype(np.float64) if k in wide else t for t in v)
                for k, v in _inputs().items()}
        return jax.device_get(run(data))


@pytest.fixture(scope='module')
def ranks(job):
    _jax()                                          # while the ranks run
    tmp, started = job
    started.finish(timeout=120)
    return [torch.load(tmp / f'resize-rank{r}.pt', weights_only=False) for r in range(WORLD)]


def _close(got, want, exact, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize('name', [c[0] for c in STRIP_CASES])
def test_strip_resize_matches_jax_on_the_whole_tile(ranks, name):
    """Each rank's output is the JAX package's whole output's rows of its
    strip, and its input gradient the whole gradient's rows of its strip
    (exact for nearest, 1e-6 for bilinear)."""
    y, g = _jax()[name]
    exact = name.startswith('nearest')
    h, m = TILE[1] // WORLD, y.shape[1] // WORLD
    for r, (got_y, got_g, _) in enumerate(res[name] for res in ranks):
        _close(got_y.numpy(), y[:, r * m:(r + 1) * m], exact, f'{name}: rank {r} output')
        _close(got_g.numpy(), g[:, r * h:(r + 1) * h], exact, f'{name}: rank {r} gradient')


@pytest.mark.parametrize('name', [c[0] for c in WHOLE_CASES])
def test_whole_map_resized_to_the_strips_matches_jax(ranks, name):
    """A map whole on every rank resized to the strips: each rank's output
    is the JAX package's whole output's rows of its strip, and the ranks'
    gradients of the map (each its strip's share) sum to the whole
    gradient; 1e-6."""
    y, g = _jax()[name]
    m = TILE[1] // WORLD
    for r, (got_y, _, sent) in enumerate(res[name] for res in ranks):
        _close(got_y.numpy(), y[:, r * m:(r + 1) * m], False, f'{name}: rank {r} output')
        assert sent == 0, (name, sent)
    _close(sum(res[name][1] for res in ranks).numpy(), g, False, f'{name}: gradient')


def test_a_strip_reads_the_halo_rows_of_the_whole_matrix_s_support(ranks):
    """The bytes each rank sent for a case, forward and backward, are the
    halo rows the whole matrix's support reads (``HALO_ROWS``)."""
    for r, res in enumerate(ranks):
        for name, _, _, _ in STRIP_CASES:
            assert res[name][2] == HALO_ROWS.get(name, 0) * ROW_BYTES, (r, name, res[name][2])
