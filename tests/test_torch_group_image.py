"""K2's image form (X11): the grouped render paths' shade and assembly in
one launch, each pixel reading its bin's place from X10's inverse of the
depth order (``ginv``). Its plain version (``ops/raster_shade.
shade_image_ref``) against JAX's ``shade_groups`` + ``assemble_group_image``
(``ascii_renderer_tpu/backends/raster.py:624-646``) on seeded grouped
walks at three grid sizes (bins no group covers, sentinel slots) and on a
row band: the pixels' winner ids, centres and fill bit for bit (a probe
shade that returns them), the shade within 1e-5 (the reference's rsqrt is
an estimate refined by one Newton step, as ``test_torch_xla_kernels``
compares it); against the port's own grouped chain bit for bit; ``ginv``
of every generation's plain layout build against the ``scatter_`` inverse
of the assembly; the pixel centres ``c + 0.5`` / ``r + 0.5`` against
``_pixel_origins``; and ``emit="idx"``'s per-pixel quantization against
quantizing the groups, then assembling. The kernel against this plain
version on the card is ``tests/test_torch_build_xla.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.ops import raster_group as JRG
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.ops import group_build as GB
from ascii_renderer_tpu_torch.ops import raster_group as RG
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.tools.xla_inputs import (shade_builder,
                                                       shade_inputs)

torch.set_num_threads(2)

# (rows, cols, grp_cap less the bins' groups, y_off): the image a walk of
# tiles_y x tiles_x tiles assembles; grp_cap = tiles + extra, so bins no
# group covers where extra < 0 and sentinel slots where extra > 0; a row
# band's first pixel row y_off (its bins band-local, its centres global)
CASES = {
    "20x96 covered": (20, 96, 0, 0),
    "40x300 uncovered bins": (40, 300, -6, 0),
    "61x200 sentinel slots": (61, 200, 3, 0),
    "band 24x300 at row 16": (24, 300, 0, 16),
    "band 16x200 uncovered": (16, 200, -2, 40),
}
N_TRIS = 70


def _walk(case, seed=3):
    """A seeded grouped walk: sorted pair keys of random depths (some bins
    empty), the port's plain layout build (K = 8, ginv last), JAX's
    single-entry build's xl, yl, gbins over the same keys, winner ids e
    (-1 where no hit; rows past the table never), the table and the
    geometry."""
    rows, cols, extra, y_off = CASES[case]
    tiles_y, tiles_x = -(-rows // 8), -(-cols // 128)
    n_tiles = tiles_y * tiles_x
    grp_cap = n_tiles + extra
    rng = np.random.default_rng(seed + rows + cols)
    depths = rng.choice([0, 0, 1, 2, 5, 9, 14], n_tiles * 8)
    keys = np.concatenate(
        [(b << 18) | np.sort(rng.choice(N_TRIS, d, replace=False))
         for b, d in enumerate(depths) if d]).astype(np.int32)
    src = rng.normal(size=(N_TRIS, 32)).astype(np.float32)
    caps = (tiles_x, n_tiles, 32 * 64, 1 << 16, grp_cap)
    lay = GB.build_rows(torch.from_numpy(src), torch.from_numpy(keys), *caps,
                        k=8)
    jlay = JRG.build_packed_rows_grouped(jnp.asarray(src), jnp.asarray(keys),
                                         *caps)
    xl, yl, gbins = (np.asarray(jlay[k]) for k in (3, 4, 5))
    np.testing.assert_array_equal(lay[-5].numpy(), gbins)
    e = rng.integers(-1, N_TRIS, (grp_cap, 8, 128)).astype(np.float32)
    e[rng.random(e.shape) < 0.3] = -1.0
    return dict(rows=rows, cols=cols, y_off=y_off, tiles_x=tiles_x,
                tiles_y=tiles_y, n_tiles=n_tiles, grp_cap=grp_cap, lay=lay,
                xl=xl, yl=yl + np.float32(y_off), gbins=gbins,
                e=e)


def _scenes(n_attrs):
    n_pts = 2 if n_attrs == 9 else 0
    return (shade_builder(TSB, True, n_pts).build(device="cpu"),
            shade_builder(JSB, True, n_pts).build())


def _jax_image(w, table, js, n_attrs):
    # a new function each call: jax.jit caches its trace by function, and
    # the probe test traces shade_groups with _shade_rows replaced
    rgbg = jax.jit(lambda *a: JR.shade_groups(*a, n_attrs))(
        jnp.asarray(w["e"]), jnp.asarray(w["xl"]), jnp.asarray(w["yl"]),
        jnp.asarray(table), js)
    return np.asarray(JRG.assemble_group_image(
        rgbg, jnp.asarray(w["gbins"]), w["n_tiles"], w["tiles_y"],
        w["tiles_x"], w["rows"], w["cols"], 0.0))


def _groups(w):
    """(xl, yl, gbins, ginv) of the port's layout, yl moved to the band's
    rows as its build moves them."""
    lay = w["lay"]
    return lay[-7], lay[-6] + float(w["y_off"]), lay[-5], lay[-1]


def _port_image(w, table, ts, n_attrs):
    return RSH.shade_image(torch.from_numpy(table), torch.from_numpy(w["e"]),
                           *_groups(w), ts, n_attrs, w["tiles_x"], w["rows"],
                           w["cols"], w["y_off"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_form_plain_picks_and_centres_equal_jax(case, monkeypatch):
    """Each pixel's winner id, centre (px, py) and the fill where no group
    covers its bin, as JAX's shade_groups gathers them and its assembly
    places them, bit for bit: a probe in place of ``_shade_rows`` (in both
    packages, for this test) returns (id, px, py) a pixel."""
    w = _walk(case)
    table = np.zeros((N_TRIS + 1, 21), np.float32)
    table[:, 0] = np.arange(N_TRIS + 1)

    def j_probe(g, hit, px, py, scene, n_attrs):
        ids = jnp.where(hit, g[:, 0].reshape(px.shape), -1.0)
        return jnp.stack([ids, px, py], axis=-1)

    def t_probe(g, hit, px, py, scene, n_attrs):
        ids = torch.where(hit, g[:, 0].reshape(px.shape), -1.0)
        return torch.stack([ids, px, py], dim=-1)

    ts, js = _scenes(6)
    monkeypatch.setattr(JR, "_shade_rows", j_probe)
    monkeypatch.setattr(RSH, "_shade_rows", t_probe)
    want = _jax_image(w, table, js, 6)
    got = _port_image(w, table, ts, 6).numpy()
    assert got.shape == want.shape == (w["rows"], w["cols"], 3)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    covered = got[..., 1] > 0  # px >= 0.5 where a group covers the bin
    assert (got[covered][:, 0] >= 0).any() and (got[covered][:, 0] < 0).any()
    if CASES[case][2] < 0:
        assert (~covered).any() and (got[~covered] == 0).all()
    else:
        assert covered.all()


@pytest.mark.parametrize("n_attrs", [6, 9])
@pytest.mark.parametrize("case", sorted(CASES))
def test_image_form_plain_equals_jax_shade_and_assembly(case, n_attrs):
    """The shaded image against JAX's shade_groups + assemble_group_image:
    no-hit and uncovered pixels exactly 0 in both, colours within 1e-5."""
    w = _walk(case)
    table = shade_inputs(n_attrs, (1,), n_tris=N_TRIS)[0].numpy()
    ts, js = _scenes(n_attrs)
    want = _jax_image(w, table, js, n_attrs)
    got = _port_image(w, table, ts, n_attrs).numpy()
    lit = (want != 0).any(-1)
    np.testing.assert_array_equal(got[~lit], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert lit.mean() > 0.3


@pytest.mark.parametrize("n_attrs", [6, 9])
@pytest.mark.parametrize("case", sorted(CASES))
def test_image_form_plain_equals_the_grouped_chain(case, n_attrs):
    """shade_image on the CPU equals the port's grouped shade over the
    layout's own lanes, then its assembly over the layout's gbins, bit for
    bit (render_soup_diag's CPU route; the kernel is held to this)."""
    w = _walk(case)
    table = shade_inputs(n_attrs, (1,), n_tris=N_TRIS)[0]
    ts, _js = _scenes(n_attrs)
    e = torch.from_numpy(w["e"])
    xl, yl, gbins, _ginv = _groups(w)
    rgbg = R.shade_groups(e, xl, yl, table, ts, n_attrs)
    want = RG.assemble_group_image(rgbg, gbins, w["n_tiles"], w["tiles_y"],
                                   w["tiles_x"], w["rows"], w["cols"], 0.0)
    got = _port_image(w, table.numpy(), ts, n_attrs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # emit="idx": a pixel at a time on the image, as quantizing the groups
    # and assembling both planes (the fill cells included)
    idx, rgb8 = R.image_emit(got, "idx", 10)
    rgb8g = Q.float_rgb_to_u8(rgbg)
    bidx = Q.quantize_index(rgb8g, 10)
    args = (gbins, w["n_tiles"], w["tiles_y"], w["tiles_x"], w["rows"],
            w["cols"], 0)
    assert torch.equal(idx, RG.assemble_group_image(bidx, *args))
    assert torch.equal(rgb8, RG.assemble_group_image(rgb8g, *args))
    assert R.image_emit(got, "rgb", 10) is got


@pytest.mark.parametrize("gen", ["subtile3", "subtile4", "subtile5",
                                 "subtile8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ginv_is_the_assembly_inverse(case, gen):
    """The plain layout build's ginv (every generation's, subtile4's torch
    grouping too) is a permutation of the bins whose places below grp_cap *
    8 are the ``scatter_`` inverse of assemble_group_image, the rest past
    them (its fill)."""
    w = _walk(case)
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(np.concatenate(
        [(b << 18) | np.arange(d) for b, d in enumerate(
            rng.choice([0, 1, 3, 40], w["n_tiles"] * 8)) if d]).astype(
                np.int32))
    src = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    lay = RG.GENERATIONS[gen].build(src, keys, w["tiles_x"], w["n_tiles"],
                                    32 * 256, 1 << 16, w["grp_cap"],
                                    y_off=w["y_off"])
    ginv, gbins = lay[-1], lay[-5]
    n_bins, nsel = w["n_tiles"] * 8, w["grp_cap"] * 8
    assert ginv.dtype == torch.int32 and ginv.shape == (n_bins,)
    assert torch.equal(torch.sort(ginv).values,
                       torch.arange(n_bins, dtype=torch.int32))
    inv = torch.full((n_bins + 1,), nsel, dtype=torch.long)
    inv.scatter_(0, gbins.long(), torch.arange(nsel, dtype=torch.long))
    assert torch.equal(torch.clamp(ginv.long(), max=nsel), inv[:n_bins])


@pytest.mark.parametrize("case", sorted(CASES))
def test_pixel_centres_are_the_lane_origins(case):
    """c + 0.5 and y_off + r + 0.5 in float32 (the image form's centres)
    are exactly the lane origins xl and yl + s + 0.5 of the bins' groups
    as the assembly places them."""
    w = _walk(case)
    xl, yl, gbins = (torch.from_numpy(w[k]) for k in ("xl", "yl", "gbins"))
    s = torch.arange(8, dtype=torch.float32) + 0.5
    lanes = torch.stack([xl[:, None, :].expand(-1, 8, -1),
                         yl[:, None, :] + s[None, :, None]], dim=-1)
    img = RG.assemble_group_image(lanes, gbins, w["n_tiles"], w["tiles_y"],
                                  w["tiles_x"], w["rows"], w["cols"], -1.0)
    covered = img[..., 0] >= 0
    r = torch.arange(w["rows"], dtype=torch.int32)[:, None]
    c = torch.arange(w["cols"], dtype=torch.int32)[None, :]
    px = (c.to(torch.float32) + 0.5).expand(w["rows"], -1)
    py = ((r + w["y_off"]).to(torch.float32) + 0.5).expand(-1, w["cols"])
    assert torch.equal(img[..., 0][covered], px[covered])
    assert torch.equal(img[..., 1][covered], py[covered])
    assert covered.float().mean() > 0.5


def test_shade_image_refuses_an_image_outside_its_bins():
    """An image the bins do not cover is refused before any launch (on a
    device the CPU's plain version does not serve: here the meta device)."""
    w = _walk("20x96 covered")
    table = shade_inputs(6, (1,), n_tris=N_TRIS)[0]
    ts, _ = _scenes(6)
    args = [t.to("meta") for t in (table, torch.from_numpy(w["e"]),
                                    *_groups(w))]
    for rows, cols, tiles_x in ((w["tiles_y"] * 8 + 1, 96, 1), (8, 129, 1),
                                (8, 96, 2)):
        with pytest.raises(ValueError, match="inside"):
            RSH.shade_image(*args, ts, 6, tiles_x, rows, cols)
