"""Plain reference of one ping chunk of survey prediction.

The laws are the reference pipeline's (CRIMAC-classifiers-unet
save_predict.py, gridded.py, the memmap and zarr data readers) as the
program's configuration selects them, written out again from the raw
survey:

* chunks: ``linspace`` splits of the survey into pieces of at most
  ``preload_n_pings`` pings;
* the patch grid of a chunk: stride ``patch - 2 * overlap``, rows down to
  the chunk's deepest seabed + 50 (a ping without a seabed counts as the
  whole water column), columns over the chunk; under ``static_grid`` the
  survey's largest grid;
* the slab the patches read, in padded grid coordinates: survey rows from
  ``overlap`` down, survey columns from ``chunk start - overlap`` (a zarr
  chunk reads one column less on the right, as the reference's preload
  does), raw zeros elsewhere; the dB transform ``clip(10 log10(sv +
  1e-10), -75, 0)`` after non-finite sv -> 0; a memmap survey's pixels
  outside its data rectangle 0.0 after the transform;
* the transfer law the configuration names: ``bfloat16`` rounds the raw
  sv to nearest even, ``uint8`` the dB to ``round((dB + 75) * 255 / 75)``
  codes;
* patch mode: softmax of every patch, the ``overlap``-trimmed interiors
  tiled; slab mode: one forward over the grid padded with 0.0 to the
  architecture's alignment (the U-Net's pooling alignment ``2 ** (depth -
  1)``);
* the write mask: a label that is finite, finite channel-0 sv, not (below
  the seabed + 10 rows and labelled background), above the grid's last
  data row; "below" is ``row >= seabed + 10`` for a memmap survey and
  ``row >= max(seabed, band top) + 10`` for a zarr survey, the band top
  being the first data row of the patch band the row lies in.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import exact_float32

SEABED_PAD = 10
NO_SEABED = 2 ** 30


def chunk_splits(n_pings, preload_n_pings):
    n = int(np.ceil(n_pings / preload_n_pings))
    edges = np.linspace(0, n_pings, n + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def _ceil_div(a, b):
    return -(-a // b)


class Geometry:
    """The grid law of one configuration over one survey; ``align`` is
    the slab's alignment (slab mode only)."""

    def __init__(self, cfg, n_range, n_pings, seabed, known, is_zarr,
                 align=None):
        self.wh, self.ww = cfg["patch_size"]
        self.o = int(cfg["patch_overlap"])
        self.sh, self.sw = self.wh - 2 * self.o, self.ww - 2 * self.o
        self.n_range, self.n_pings = n_range, n_pings
        self.sb = np.where(known, np.asarray(seabed, np.int64), NO_SEABED)
        self.sb_eff = np.where(known, np.asarray(seabed, np.int64), n_range)
        self.is_zarr = is_zarr
        self.slab = cfg.get("infer_mode", "patch") == "slab"
        self.align = align
        self.splits = chunk_splits(n_pings, int(cfg["preload_n_pings"]))
        self.fixed = None
        if cfg.get("static_grid", False):
            self.fixed = (self._rows(0, n_pings),
                          max(_ceil_div(b - a, self.sw)
                              for a, b in self.splits))

    def _rows(self, s, e):
        end = int(min(max(self.sb_eff[s:e].max() + 50, 1), self.n_range))
        return _ceil_div(end, self.sh)

    def chunk(self, s, e):
        """Extents of chunk [s, e) (see the module docstring)."""
        o, sh, sw = self.o, self.sh, self.sw
        R_ref, C_ref = self._rows(s, e), _ceil_div(e - s, sw)
        R, C = (R_ref, C_ref) if self.fixed is None else \
            (max(self.fixed[0], R_ref), max(self.fixed[1], C_ref))
        Hp, Wp = R * sh + 2 * o, C * sw + 2 * o
        x0 = max(0, s - o)
        x1 = min(self.n_pings, s + C_ref * sw + (o - 1 if self.is_zarr
                                                 else o))
        y1 = min(self.n_range, R_ref * sh + o)
        static = self.fixed is not None
        return dict(R=R, C=C, Hp=Hp, Wp=Wp, x0=x0, x1=x1, y1=y1,
                    x_off=o + x0 - s,
                    Hs=Hp if static else min(o + y1, Hp),
                    row_cut=min(R_ref * sh, self.n_range),
                    nr=R * sh if static else min(R * sh, self.n_range))


def _db(x):
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(10.0 * torch.log10(x + 1e-10), -75.0, 0.0)


def _transfer(raw, transfer_dtype):
    """The network's dB input from raw sv under the transfer law."""
    if transfer_dtype == "bfloat16":
        return _db(raw.to(torch.bfloat16).to(torch.float32))
    d = _db(raw)
    if transfer_dtype == "uint8":
        codes = torch.floor((d + 75.0) * (255.0 / 75.0) + 0.5)
        return codes / (255.0 / 75.0) - 75.0
    return d


def net_input(g, ext, sv_block, transfer_dtype):
    """(C, Hp, Wp) float32 dB image of one chunk's grid; ``sv_block`` is
    the (y1, x1 - x0, C) raw sv of the slab's data rectangle."""
    o = g.o
    C = sv_block.shape[-1]
    img = torch.full((C, ext["Hp"], ext["Wp"]), -75.0,
                     device=sv_block.device)
    ya, yb = o, o + ext["y1"]
    xa, xb = ext["x_off"], ext["x_off"] + ext["x1"] - ext["x0"]
    img[:, ya:yb, xa:xb] = _transfer(sv_block.permute(2, 0, 1),
                                     transfer_dtype)
    if not g.is_zarr:
        inside = torch.zeros_like(img[0], dtype=torch.bool)
        inside[ya:yb, xa:xb] = True
        img = torch.where(inside, img, torch.zeros_like(img))
    return img


def probabilities(g, ext, img, state, forward, quant=None, batch=8):
    """(R*sh, C*sw, 2) [sandeel, other] probabilities in grid
    coordinates; ``forward(state, x, quant)`` is the architecture's
    reference forward."""
    o, wh, ww, sh, sw = g.o, g.wh, g.ww, g.sh, g.sw
    R, C = ext["R"], ext["C"]
    with torch.no_grad(), exact_float32():
        if g.slab:
            p = g.align
            H16, W16 = _ceil_div(ext["Hp"], p) * p, _ceil_div(ext["Wp"], p) * p
            x = torch.zeros((1, img.shape[0], H16, W16), device=img.device)
            x[0, :, :ext["Hp"], :ext["Wp"]] = img
            prob = torch.softmax(forward(state, x, quant), 1)
            return prob[0, 1:3, o:o + R * sh, o:o + C * sw].permute(1, 2, 0)
        starts = [(i * sh, j * sw) for i in range(R) for j in range(C)]
        out = torch.empty((R * sh, C * sw, 2), device=img.device)
        for k in range(0, len(starts), batch):
            part = starts[k:k + batch]
            x = torch.stack([img[:, y:y + wh, c:c + ww] for y, c in part])
            prob = torch.softmax(forward(state, x, quant), 1)
            for (y, c), pr in zip(part, prob):
                out[y:y + sh, c:c + sw] = \
                    pr[1:3, o:wh - o, o:ww - o].permute(1, 2, 0)
        return out


def write_mask(g, ext, s, e, labels, sv0_finite):
    """(n_range, e - s) bool: the pixels the chunk writes.  ``labels`` is
    the (row_cut, e - s) label map, ``sv0_finite`` the (n_range, e - s)
    finiteness of channel-0 sv."""
    w = e - s
    rows = np.arange(g.n_range)[:, None]
    sb = g.sb[s:e][None, :]
    if g.is_zarr:
        band_top = np.maximum((rows // g.sh) * g.sh - g.o, 0)
        below = rows >= np.maximum(sb, band_top) + SEABED_PAD
    else:
        below = rows >= sb + SEABED_PAD
    rc = ext["row_cut"]
    fin = np.zeros((g.n_range, w), bool)
    zero = np.zeros((g.n_range, w), bool)
    fin[:rc] = np.isfinite(labels[:rc])
    zero[:rc] = labels[:rc] == 0
    keep = fin & sv0_finite & ~(below & zero)
    keep &= rows < min(rc, ext["nr"])
    return keep


def chunk_reference(g, survey, s, e, state, cfg, forward, quant=None,
                    device="cuda"):
    """(probabilities (2, n_range, e - s) float32 with 0 where not
    written, write mask (n_range, e - s) bool) of chunk [s, e) from the
    raw survey through the architecture's reference ``forward``: the
    reference, or with ``quant`` the control."""
    ext = g.chunk(s, e)
    block = survey.sv(ext["x0"], ext["x1"], ext["y1"])
    img = net_input(g, ext, torch.from_numpy(block).to(device),
                    cfg["transfer_dtype"])
    prob = probabilities(g, ext, img, state, forward, quant).cpu().numpy()
    w = e - s
    out = np.zeros((2, g.n_range, w), np.float32)
    h = min(prob.shape[0], g.n_range)
    out[:, :h] = prob[:h, :w].transpose(2, 0, 1)
    # rows below the slab's data rows read its zero fill: finite
    sv0 = np.ones((g.n_range, w), bool)
    sv0[:ext["y1"]] = np.isfinite(survey.sv(s, e, ext["y1"])[:, :, 0])
    keep = write_mask(g, ext, s, e, survey.labels(s, e, ext["row_cut"]),
                      sv0)
    return np.where(keep[None], out, 0.0), keep


def quantize_output(prob, output_dtype):
    """The stored value of a probability: float16, or a uint8 code
    ``round(p * 255)`` read back as float16(code / 255)."""
    if output_dtype == "uint8":
        codes = np.round(prob * 255.0)
        return (codes.astype(np.float32) / np.float32(255.0)).astype(
            np.float16)
    return prob.astype(np.float16)
