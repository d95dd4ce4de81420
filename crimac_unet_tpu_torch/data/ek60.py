"""EK60 raw-data onboarding: .raw/.bot/.snap -> the .mat-equivalent arrays.

Pure-Python replacement for the reference's offline MATLAB chain
(reference data_preprocessing/generate_mat_files.m:1-381 +
generate_transducerdepthsfromraw.m), which it could not ship outside a
MATLAB/LSSSreader/readEKraw installation.  The behavioral contract is the
.mat payload that the rest of the pipeline consumes
(generate_mat_files.m:206 ``save(datfile,'I','sv','F','t','range',
'depths','heave')``, read by :mod:`.mat_to_memmap`):

  * parse Simrad EK60 ``.raw`` datagram streams (CON0 configuration +
    RAW0 sample datagrams, little-endian, length-framed);
  * convert received power to volume backscatter Sv with the standard
    EK60 TVG equation (readEKRaw_Power2Sv semantics);
  * assemble the per-channel pings onto a common time grid: times are
    rounded to the main channel's minimal ping interval and unioned
    across channels; missing pings become NaN columns
    (generate_mat_files.m:85-131);
  * regrid every channel's range axis onto the main-frequency range
    vector (kept / bin-averaged with edges R +- dz/2 / linearly
    interpolated, :132-156);
  * crop below ``percentile(bottomdepth, bottomoutlier) + depthoffset``
    (:57, :194-200) using the ``.bot`` bottom-depth datagrams;
  * rasterize LSSS ``.snap`` school polygons (shifted down by the median
    transducer depth) into the label image ``I`` with the max-fraction
    species ID (:160-191).

Fixture .raw/.bot/.snap writers for tests live in
:func:`write_raw_fixture` etc.

The port's copy of the JAX package's ``crimac_unet_tpu/data/ek60.py``.
One change of means, none of result: the polygon rasterization tests its
points with :func:`_points_in_polygon`, matplotlib's crossing-number
test (``Path.contains_points``, radius 0) written in numpy, so the
onboarding runs where matplotlib is absent.
"""

from __future__ import annotations

import math
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

# NT epoch (1601-01-01) -> unix epoch offset in 100ns ticks
_NT_UNIX_OFFSET = 116444736000000000
# RAW0 fixed part after the 4+8-byte datagram header:
#   short channel, mode; 12 floats (transducerdepth, frequency,
#   transmitpower, pulselength, bandwidth, sampleinterval, soundvelocity,
#   absorptioncoefficient, heave, roll, pitch, temperature);
#   short spare1, spare2; int32 offset, count  (Simrad EK60 ref manual)
_RAW0_FIXED = struct.Struct("<hh12fhhll")
_POWER_DB = 10.0 * math.log10(2.0) / 256.0  # int16 power -> dB
# SaCorrectionTable[0] offset inside a CON0 transducer block: channelid
# (128) + beamtype/freq/gain/eba (16) + beamwidths+angle sens+offsets
# (24) + pos+dir (24) + pulselengthtable (20) + spare (8) + gaintable
# (20) + spare (8) = 248
_SA_OFFSET = 248


def _nt_to_unix(low: int, high: int) -> float:
    ticks = (high << 32) | (low & 0xFFFFFFFF)
    return (ticks - _NT_UNIX_OFFSET) / 1e7


def _unix_to_nt(t: float) -> tuple[int, int]:
    ticks = int(round(t * 1e7)) + _NT_UNIX_OFFSET
    return ticks & 0xFFFFFFFF, ticks >> 32


@dataclass
class Raw0Ping:
    channel: int          # 1-based transceiver index
    time: float           # unix seconds
    transducerdepth: float
    frequency: float      # Hz
    transmitpower: float  # W
    pulselength: float    # s
    sampleinterval: float  # s
    soundvelocity: float  # m/s
    absorption: float     # dB/m
    heave: float
    offset: int
    power: np.ndarray     # int16 raw power


@dataclass
class ChannelConfig:
    channel_id: str = ""
    frequency: float = 0.0
    gain: float = 25.0            # dB
    equivalent_beam_angle: float = -20.7  # dB re 1 steradian
    sa_correction: float = 0.0    # dB


@dataclass
class RawFile:
    channels: list = field(default_factory=list)   # [ChannelConfig]
    pings: dict = field(default_factory=dict)      # ch -> [Raw0Ping]


# ================================================================= datagrams
def _iter_datagrams(buf: bytes):
    """Yield (dtype, payload) from a length-framed Simrad datagram stream."""
    pos, n = 0, len(buf)
    while pos + 4 <= n:
        (length,) = struct.unpack_from("<l", buf, pos)
        pos += 4
        if length < 12:
            raise ValueError(f"corrupt datagram framing at byte {pos - 4}")
        if pos + length + 4 > n:
            # truncated FINAL datagram (abrupt logger stop / power loss):
            # keep the readable prefix like readEKRaw-style readers —
            # raising here used to lose the whole file's valid pings
            print(f"WARNING: truncated datagram at byte {pos - 4} "
                  f"(file ends {pos + length + 4 - n} bytes short); "
                  "keeping the readable prefix")
            return
        dtype = buf[pos:pos + 4].decode("ascii", "replace")
        yield dtype, buf[pos:pos + length]
        pos += length
        (trailer,) = struct.unpack_from("<l", buf, pos)
        if trailer != length:
            raise ValueError(f"datagram trailer mismatch at byte {pos}")
        pos += 4


def _frame(dtype: bytes, time_unix: float, body: bytes) -> bytes:
    low, high = _unix_to_nt(time_unix)
    payload = dtype + struct.pack("<LL", low, high) + body
    n = struct.pack("<l", len(payload))
    return n + payload + n


def read_raw(path) -> RawFile:
    """Parse an EK60 .raw file: CON0 channel configs + RAW0 pings."""
    with open(path, "rb") as f:
        buf = f.read()
    out = RawFile()
    n_datagrams = 0
    for dtype, payload in _iter_datagrams(buf):
        n_datagrams += 1
        low, high = struct.unpack_from("<LL", payload, 4)
        t = _nt_to_unix(low, high)
        body = payload[12:]
        if dtype == "CON0":
            # header: survey/transect/sounder names (char[128] x3),
            # version char[30], spare char[98], int32 transducercount;
            # then 320-byte transducer blocks (Simrad EK60 ref manual):
            #   channelid char[128] | beamtype l | frequency f | gain f |
            #   equivalentbeamangle f | beamwidths/angle-sens/offsets 6f |
            #   pos 3f dir 3f | pulselengthtable 5f | spare char[8] |
            #   gaintable 5f | spare char[8] | sacorrectiontable 5f @ +248
            (count,) = struct.unpack_from("<l", body, 128 * 3 + 30 + 98)
            off = 128 * 3 + 30 + 98 + 4
            for _ in range(count):
                cid = body[off:off + 128].split(b"\x00")[0].decode(
                    "ascii", "replace")
                beamtype, freq, gain, eba = struct.unpack_from(
                    "<lfff", body, off + 128)
                (sa,) = struct.unpack_from("<f", body, off + _SA_OFFSET)
                out.channels.append(ChannelConfig(
                    channel_id=cid, frequency=freq, gain=gain,
                    equivalent_beam_angle=eba, sa_correction=sa))
                off += 320
        elif dtype == "RAW0":
            (ch, mode, tdepth, freq, power_w, plen, _bw, sint, c_sound,
             alpha, heave, _roll, _pitch, _temp, _s1, _s2, offset,
             count) = _RAW0_FIXED.unpack_from(body, 0)
            data_off = _RAW0_FIXED.size
            power = np.frombuffer(body, "<i2", count, data_off)
            out.pings.setdefault(ch, []).append(Raw0Ping(
                channel=ch, time=t, transducerdepth=tdepth, frequency=freq,
                transmitpower=power_w, pulselength=plen,
                sampleinterval=sint, soundvelocity=c_sound,
                absorption=alpha, heave=heave, offset=offset,
                power=power))
    if n_datagrams == 0:
        # nothing parsed at all: that is corruption, not a truncated
        # tail — the prefix-tolerance above must not turn garbage into
        # an empty-but-ok file
        raise ValueError(f"no complete datagrams in {path}")
    return out


def read_bot(path):
    """Parse a .bot file of BOT0 datagrams -> (times (P,), depths (P, T))
    per-transceiver detected bottom depths."""
    with open(path, "rb") as f:
        buf = f.read()
    times, depths = [], []
    for dtype, payload in _iter_datagrams(buf):
        if dtype != "BOT0":
            continue
        low, high = struct.unpack_from("<LL", payload, 4)
        (count,) = struct.unpack_from("<l", payload, 12)
        d = np.frombuffer(payload, "<f8", count, 16)
        times.append(_nt_to_unix(low, high))
        depths.append(d)
    return np.asarray(times), np.asarray(depths)


# ============================================================== power -> Sv
def power_to_sv(ping: Raw0Ping, cfg: ChannelConfig) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """Received power (int16) -> Sv (linear) with the standard EK60 TVG
    equation (readEKRaw_Power2Sv semantics):

      Sv_dB = Pr + 20 log10(r) + 2 a r
              - 10 log10(Pt G^2 lambda^2 c tau psi / (32 pi^2))
              - 2 Sa_corr

    Returns (sv_linear (count,), range_m (count,)).
    """
    pr_db = ping.power.astype(np.float64) * _POWER_DB
    dr = ping.soundvelocity * ping.sampleinterval / 2.0
    r = (np.arange(ping.power.size) + ping.offset) * dr
    rc = np.maximum(r, dr)  # avoid log(0) at the transducer face
    lam = ping.soundvelocity / ping.frequency
    g = 10.0 ** (cfg.gain / 10.0)
    psi = 10.0 ** (cfg.equivalent_beam_angle / 10.0)
    const_db = 10.0 * np.log10(
        ping.transmitpower * g * g * lam * lam * ping.soundvelocity
        * ping.pulselength * psi / (32.0 * np.pi ** 2))
    sv_db = (pr_db + 20.0 * np.log10(rc) + 2.0 * ping.absorption * rc
             - const_db - 2.0 * cfg.sa_correction)
    return 10.0 ** (sv_db / 10.0), r


# ============================================================= snap labels
def read_snap(path):
    """Minimal LSSS .snap reader: school polygons with per-channel species
    interpretations (the subset LSSSreader_readsnapfiles feeds into the
    label rasterization, generate_mat_files.m:160-191).

    Expected XML:
      <snap><school>
        <polygon> x0,y0 x1,y1 ... </polygon>
        <channel><species id="27" fraction="1.0"/></channel>
      </school></snap>
    """
    root = ET.parse(str(path)).getroot()
    schools = []
    for sc in root.iter("school"):
        poly = sc.findtext("polygon", "").split()
        pts = np.array([[float(v) for v in p.split(",")] for p in poly])
        species = []
        for chan in sc.iter("channel"):
            for sp in chan.iter("species"):
                species.append((int(sp.get("id")),
                                float(sp.get("fraction", 1.0))))
        if len(pts) >= 3 and species:
            schools.append({"x": pts[:, 0], "y": pts[:, 1],
                            "species": species})
    return schools


def _points_in_polygon(vx, vy, px, py) -> np.ndarray:
    """Which points (px, py) lie inside the closed polygon (vx, vy): the
    crossing-number test of matplotlib's ``Path.contains_points`` with
    radius 0 (``point_in_path_impl``, src/_path.h), edge by edge in the
    same float64 arithmetic, so points on an edge fall the same way."""
    inside = np.zeros(px.shape, dtype=bool)
    n = len(vx)
    for k in range(n):
        x0, y0 = vx[k], vy[k]
        x1, y1 = vx[(k + 1) % n], vy[(k + 1) % n]
        yflag1 = y1 >= py
        crosses = (y0 >= py) != yflag1
        hit = ((y1 - py) * (x0 - x1) >= (x1 - px) * (y0 - y1)) == yflag1
        inside ^= crosses & hit
    return inside


def _rasterize_schools(schools, t_idx, R, td):
    """Label image I (len(R), n_pings): polygon interiors get the
    max-fraction species ID; polygon y is depth shifted up by the median
    transducer depth (generate_mat_files.m:181 ``school.y - td``)."""
    I = np.zeros((len(R), len(t_idx)))
    if not schools:
        return I
    xs = np.arange(1, len(t_idx) + 1)
    R = np.asarray(R)
    for school in schools:
        sid = max(school["species"], key=lambda s: s[1])[0]
        vx = np.asarray(school["x"], dtype=np.float64)
        vy = np.asarray(school["y"], dtype=np.float64) - td
        # restrict the point-in-polygon test to the polygon's bbox: a
        # full-image test per school made rasterization the dominant
        # onboarding cost (O(H*W) points x n_schools)
        ci = np.nonzero((xs >= vx.min()) & (xs <= vx.max()))[0]
        ri = np.nonzero((R >= vy.min()) & (R <= vy.max()))[0]
        if not len(ci) or not len(ri):
            continue
        Xs, Ys = np.meshgrid(xs[ci], R[ri])
        inside = _points_in_polygon(vx, vy, Xs.ravel().astype(np.float64),
                                    Ys.ravel().astype(np.float64))
        sub = I[np.ix_(ri, ci)]
        flat = sub.ravel()
        flat[inside] = sid
        I[np.ix_(ri, ci)] = flat.reshape(sub.shape)
    return I


# ========================================================== grid assembly
def raw_to_arrays(raw_path, bot_path=None, snap_path=None,
                  range_frequency=200, dz=None, dzdiff=0.01,
                  bottomoutlier=98, depthoffset=15.0):
    """One .raw (+.bot +.snap) -> the .mat-equivalent dict
    {'I','sv','F','t','range','depths','heave'}
    (generate_mat_files.m:74-206).  ``sv`` is (range, ping, freq) linear,
    missing pings NaN; ``F`` in kHz; ``range`` in meters."""
    raw = read_raw(raw_path)
    chans = sorted(raw.pings)
    F = np.array([raw.pings[ch][0].frequency / 1000.0 for ch in chans])
    if range_frequency not in set(F.astype(int)):
        raise ValueError(f"Missing main range frequency {range_frequency} "
                         f"in {F}")
    fi = int(np.where(F.astype(int) == int(range_frequency))[0][0])
    main = chans[fi]

    # per-channel sv matrices + native range vectors
    sv_ch, rng_ch, t_ch = {}, {}, {}
    for ch in chans:
        cfg = (raw.channels[ch - 1] if ch - 1 < len(raw.channels)
               else ChannelConfig(frequency=raw.pings[ch][0].frequency))
        cols, rngs = [], None
        for p in raw.pings[ch]:
            sv, r = power_to_sv(p, cfg)
            cols.append(sv)
            rngs = r
        n = max(len(c) for c in cols)
        mat = np.full((n, len(cols)), np.nan)
        for j, c in enumerate(cols):
            mat[:len(c), j] = c
        sv_ch[ch] = mat
        rng_ch[ch] = rngs if len(rngs) == n else \
            (np.arange(n) + raw.pings[ch][0].offset) * (
                raw.pings[ch][0].soundvelocity
                * raw.pings[ch][0].sampleinterval / 2.0)
        t_ch[ch] = np.array([p.time for p in raw.pings[ch]])

    # unique time grid: round to the main channel's min ping interval
    # (generate_mat_files.m:85-101); NaN-fill missing pings per channel
    # positive diffs only: duplicate main-channel timestamps (a real
    # EK60 clock-resolution artifact) would give tol=0 and t/tol would
    # collapse every ping to one time column
    _d = np.abs(np.diff(t_ch[main]))
    _d = _d[_d > 0]
    tol = float(_d.min()) if _d.size else 1.0
    tround = {ch: np.round(t_ch[ch] / tol).astype(np.int64) for ch in chans}
    t_final = np.unique(np.concatenate([tround[ch] for ch in chans]))

    # target range vector (m:104-119): keep the main channel's unless its
    # resolution deviates from dz by more than dzdiff
    r_main = rng_ch[main]
    native_dz = float(np.median(np.diff(r_main)))
    if dz is not None and abs(native_dz - dz) > dzdiff:
        R = np.arange(r_main[0], r_main[-1] + 1e-9, dz)
    else:
        R = r_main
        dz = native_dz

    # NaN init: target bins no source row reaches (e.g. a shorter-range
    # channel bin-averaged onto the main grid) must read as missing, not
    # as silent zero backscatter
    sv = np.full((len(R), len(t_final), len(chans)), np.nan)
    for k, ch in enumerate(chans):
        dum = np.full((sv_ch[ch].shape[0], len(t_final)), np.nan)
        locb = np.searchsorted(t_final, tround[ch])
        dum[:, locb] = sv_ch[ch]
        if len(R) == len(rng_ch[ch]) and np.allclose(R, rng_ch[ch]):
            # same COUNT is not enough: a channel with an equal sample
            # count but different sample interval must be regridded, not
            # copied onto the wrong depths (the reference keys on range
            # values, generate_mat_files.m:132)
            sv[:, :, k] = dum
        elif len(R) < len(rng_ch[ch]):
            # bin-average onto edges R +- dz/2 (m:138-148)
            edges = np.concatenate([R - 0.5 * dz, [R[-1] + 0.5 * dz]])
            bins = np.digitize(rng_ch[ch], edges) - 1
            ok = (bins >= 0) & (bins < len(R))
            for b in range(len(R)):
                rows = ok & (bins == b)
                if rows.any():
                    sv[b, :, k] = np.nanmean(dum[rows], axis=0)
        else:
            # linear interpolation onto the finer grid (m:149-153)
            for j in range(dum.shape[1]):
                sv[:, j, k] = np.interp(R, rng_ch[ch], dum[:, j],
                                        left=np.nan, right=np.nan)

    # per-ping vectors on the SAME union time grid as sv's ping axis
    # (one entry per t_final slot; the main channel's exact times where it
    # pinged, the rounded grid time where only another channel did —
    # keeps t/heave/depths length-consistent with sv for any missing-ping
    # pattern)
    t = t_final.astype(np.float64) * tol
    locb_main = np.searchsorted(t_final, tround[main])
    t[locb_main] = t_ch[main]
    heave = np.zeros(len(t_final))
    heave[locb_main] = [p.heave for p in raw.pings[main]]

    # bottom depths -> maxrange crop + per-channel depth vectors
    if bot_path is not None:
        bt, bd = read_bot(bot_path)
        maxrange = float(np.percentile(bd, bottomoutlier) + depthoffset)
        depths = np.column_stack([
            np.interp(t, bt, bd[:, min(k, bd.shape[1] - 1)])
            for k in range(len(chans))])
    else:
        maxrange = float(R[-1]) + 1.0
        depths = np.full((len(t), len(chans)), np.nan)

    td = float(np.median([p.transducerdepth for p in raw.pings[main]]))
    schools = read_snap(snap_path) if snap_path else []
    I = _rasterize_schools(schools, t_final, R, td)

    rind = R < maxrange
    # the reference's readEKRaw emits MATLAB serial date numbers; the
    # memmap reader (and its reference counterpart data_reader.py:56-100)
    # expects that convention in ``t``
    t_datenum = t / 86400.0 + 719529.0
    return {"I": I[rind], "sv": sv[rind], "F": F, "t": t_datenum,
            "range": R[rind], "depths": depths, "heave": heave}


def raw_to_matfile(raw_path, out_mat, **kw) -> str:
    """.raw -> a scipy .mat file with the reference's exact key set, ready
    for :func:`mat_to_memmap.convert_mat_file`."""
    import scipy.io as spio
    arrays = raw_to_arrays(raw_path, **kw)
    spio.savemat(str(out_mat), arrays, do_compression=True)
    return str(out_mat)


def extract_transducer_depths(raw_path) -> dict:
    """Per-channel per-ping transducer depths (replacement for
    generate_transducerdepthsfromraw.m). For the Korona mask pipeline,
    write them through :func:`save_transducer_depths` — korona reads a
    ``<name>.h5`` file, not this dict."""
    raw = read_raw(raw_path)
    return {ch: np.array([p.transducerdepth for p in pings])
            for ch, pings in raw.pings.items()}


def save_transducer_depths(raw_path, h5_path, channel=None) -> str:
    """Write the ``<name>.h5`` layout ``korona.get_transducer_depths``
    reads (group ``transducer`` holding one (n_pings, 1) depth dataset)
    — the missing bridge from raw onboarding to the Korona mask pipeline
    (generate_transducerdepthsfromraw.m's on-disk contract)."""
    import h5py
    depths = extract_transducer_depths(raw_path)
    if channel is None:
        channel = sorted(depths)[0]
    with h5py.File(h5_path, "w") as f:
        grp = f.create_group("transducer")
        grp.create_dataset(str(channel),
                           data=np.asarray(depths[channel],
                                           np.float64)[:, None])
    return str(h5_path)


# ====================================================== survey converter
def convert_survey_raw(data_dir, scratch_dir, resume=True, **par) -> dict:
    """Survey-level onboarding converter (reference
    generate_mat_main.m:83-143): walk
    ``<data_dir>/ACOUSTIC/EK60/EK60_RAWDATA/*.raw``, pair each with its
    ``.bot`` (same dir) and ``.snap`` (``ACOUSTIC/LSSS/WORK``), convert to
    per-rawfile ``.mat`` under ``scratch_dir``, tracking progress in a
    ``datastatus.json`` (succeeded files are skipped on resume, failures
    are recorded with their error and retried).  Returns
    {name: 'ok'|'skipped'|error string}.  Chain with
    :func:`mat_to_memmap.convert_survey_tree` to reach memmap echogram
    dirs.

    Also accepts the FLAT staged layout produced by
    :func:`cruise_catalog.stage_paired_files` (raw/bot/snap side by side in
    ``data_dir``, mirroring generate_metadata2.m's staging copies): when
    the ``ACOUSTIC`` convention directory is absent, ``data_dir`` itself is
    globbed for the triplets."""
    import json
    import os
    from glob import glob

    os.makedirs(scratch_dir, exist_ok=True)
    status_file = os.path.join(scratch_dir, "datastatus.json")
    status = {}
    if resume and os.path.isfile(status_file):
        with open(status_file) as f:
            status = json.load(f)

    raw_dir = os.path.join(data_dir, "ACOUSTIC", "EK60", "EK60_RAWDATA")
    # IMR standard snap location is ACOUSTIC/LSSS/INTERPRETATION
    # (cruise_catalog.STD_SNAP_DIR, generate_metadata.m:120-123); some
    # cruises stage snaps under LSSS/WORK — search both, standard first
    # (a WORK-only probe silently produced all-zero label images on
    # standard trees)
    snap_dirs = [os.path.join(data_dir, "ACOUSTIC", "LSSS",
                              "INTERPRETATION"),
                 os.path.join(data_dir, "ACOUSTIC", "LSSS", "WORK")]
    if not os.path.isdir(raw_dir):  # flat staged layout
        raw_dir = str(data_dir)
        snap_dirs = [str(data_dir)]
    results = {}
    for raw_path in sorted(glob(os.path.join(raw_dir, "*.raw"))):
        name = os.path.splitext(os.path.basename(raw_path))[0]
        if status.get(name) == "ok":
            results[name] = "skipped"
            continue
        bot = os.path.join(raw_dir, name + ".bot")
        snap = next((p for p in (os.path.join(d, name + ".snap")
                                 for d in snap_dirs)
                     if os.path.isfile(p)),
                    os.path.join(snap_dirs[0], name + ".snap"))
        try:
            raw_to_matfile(raw_path, os.path.join(scratch_dir,
                                                  name + ".mat"),
                           bot_path=bot if os.path.isfile(bot) else None,
                           snap_path=snap if os.path.isfile(snap) else None,
                           **par)
            status[name] = results[name] = "ok"
        except Exception as exc:  # record + continue (m:124-138)
            status[name] = results[name] = f"failed: {exc}"
        with open(status_file + ".tmp", "w") as f:
            json.dump(status, f, indent=2)
        os.replace(status_file + ".tmp", status_file)
    return results


# ========================================================== fixture writers
def write_raw_fixture(path, sv_linear, frequencies_khz, times,
                      sample_interval=1e-4, sound_velocity=1500.0,
                      pulse_length=1e-3, transmit_power=1000.0,
                      absorption=0.01, transducer_depth=5.0,
                      heave=None, gain=25.0, eba=-20.7, sa=0.0,
                      drop_pings=None):
    """Write a synthetic EK60 .raw byte stream whose RAW0 power samples
    invert :func:`power_to_sv` for the given target Sv — parsing +
    conversion round-trips bit-tightly in tests.  ``sv_linear``:
    (n_range, n_pings, n_freq); ``drop_pings``: {channel_1based: [ping
    indices to omit]} to exercise the NaN-fill path."""
    n_range, n_pings, n_freq = sv_linear.shape
    drop_pings = drop_pings or {}
    body = bytearray()

    # CON0
    hdr = (b"survey".ljust(128, b"\x00") + b"transect".ljust(128, b"\x00")
           + b"EK60".ljust(128, b"\x00") + b"2.0".ljust(30, b"\x00")
           + b"\x00" * 98 + struct.pack("<l", n_freq))
    blocks = b""
    for f in frequencies_khz:
        block = bytearray(320)
        block[:128] = f"GPT {f} kHz".encode().ljust(128, b"\x00")
        struct.pack_into("<lfff", block, 128, 1, f * 1000.0, gain, eba)
        struct.pack_into("<f", block, _SA_OFFSET, sa)  # SaCorrection[0]
        blocks += bytes(block)
    body += _frame(b"CON0", float(times[0]), bytes(hdr) + blocks)

    dr = sound_velocity * sample_interval / 2.0
    r = np.maximum((np.arange(n_range)) * dr, dr)
    for j in range(n_pings):
        for k, f in enumerate(frequencies_khz):
            ch = k + 1
            if j in drop_pings.get(ch, ()):
                continue
            lam = sound_velocity / (f * 1000.0)
            g = 10.0 ** (gain / 10.0)
            psi = 10.0 ** (eba / 10.0)
            const_db = 10.0 * np.log10(
                transmit_power * g * g * lam * lam * sound_velocity
                * pulse_length * psi / (32.0 * np.pi ** 2))
            sv_db = 10.0 * np.log10(np.maximum(sv_linear[:, j, k], 1e-30))
            pr_db = (sv_db - 20.0 * np.log10(r) - 2.0 * absorption * r
                     + const_db + 2.0 * sa)
            power = np.round(pr_db / _POWER_DB).astype("<i2")
            fixed = _RAW0_FIXED.pack(
                ch, 0, transducer_depth, f * 1000.0, transmit_power,
                pulse_length, 1.0, sample_interval, sound_velocity,
                absorption,
                0.0 if heave is None else float(heave[j]),
                0.0, 0.0, 10.0, 0, 0, 0, n_range)
            body += _frame(b"RAW0", float(times[j]),
                           fixed + power.tobytes())
    with open(path, "wb") as fh:
        fh.write(bytes(body))
    return str(path)


def write_bot_fixture(path, times, depths):
    """Synthetic .bot: BOT0 datagrams of per-transceiver float64 depths."""
    depths = np.asarray(depths, np.float64)
    body = bytearray()
    for j, t in enumerate(times):
        d = depths[j]
        body += _frame(b"BOT0", float(t),
                       struct.pack("<l", d.size) + d.tobytes())
    with open(path, "wb") as fh:
        fh.write(bytes(body))
    return str(path)


def write_snap_fixture(path, schools):
    """Synthetic LSSS .snap XML: [{'x': [...], 'y': [...],
    'species': [(id, fraction), ...]}]."""
    root = ET.Element("snap")
    for school in schools:
        sc = ET.SubElement(root, "school")
        poly = " ".join(f"{x},{y}" for x, y in zip(school["x"],
                                                   school["y"]))
        ET.SubElement(sc, "polygon").text = poly
        chan = ET.SubElement(sc, "channel")
        for sid, frac in school["species"]:
            ET.SubElement(chan, "species", id=str(sid),
                          fraction=str(frac))
    ET.ElementTree(root).write(str(path))
    return str(path)
