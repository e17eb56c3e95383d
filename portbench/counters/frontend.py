"""Model FLOPs of the frozen frontends and the small conv stacks, from shapes.

Every count is the products' multiply-adds times two: a linear map of M
rows from K to N features 2·M·K·N, a 1-D convolution 2·Cin·k·Cout per
output frame per row, attention 4·Tq·Tk·D per row.  ``Count`` adds them
up; with ``grad_in`` a training backward costs twice the forward (the
gradients of the input and of the weight), without it once (the weight's).
"""

from __future__ import annotations

from portbench.counters import attention

# (dim, kernel, stride) of the wav2vec feature extractor
WAV2VEC_SPEC = ((512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2))
RESAMPLE_TAPS = 41  # the 48 kHz -> 16 kHz polyphase filter: 2 * 19 + 3 taps, stride 3


class Count:
    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0

    def lin(self, M: int, K: int, N: int, grad_in: bool = True) -> None:
        f = 2.0 * M * K * N
        self.fwd += f
        self.bwd += f * (2 if grad_in else 1)

    def conv(self, rows: int, cin: int, k: int, cout: int, t_out: int) -> None:
        self.fwd += 2.0 * rows * cin * k * cout * t_out

    def attn(self, B: int, H: int, Tq: int, Tk: int, Dh: int) -> None:
        s = {"B": B, "H": H, "Tq": Tq, "Tk": Tk, "Dh": Dh}
        self.fwd += attention.model_flops("fwd", s)
        self.bwd += attention.model_flops("bwd", s)


def feature_frames(n_samples: int, spec=WAV2VEC_SPEC) -> int:
    t = n_samples
    for _, k, s in spec:
        t = (t - k) // s + 1
    return t


def resample_48k_to_16k(c: Count, rows: int, n48: int) -> int:
    """-> samples at 16 kHz."""
    n16 = -(-n48 // 3)
    c.conv(rows, 1, RESAMPLE_TAPS, 1, n48 // 3 + 1)
    return n16


def extractor(c: Count, rows: int, n16: int) -> int:
    """The wav2vec conv feature extractor over ``n16`` samples -> frames."""
    t, cin = n16, 1
    for dim, k, s in WAV2VEC_SPEC:
        t = (t - k) // s + 1
        c.conv(rows, cin, k, dim, t)
        cin = dim
    return t


def wav2vec_features(c: Count, clips: int, n48: int) -> int:
    """Both channels of ``clips`` clips through the denoisers' frontend -> tokens."""
    return extractor(c, 2 * clips, resample_48k_to_16k(c, 2 * clips, n48))


def _mha_self(c: Count, R: int, T: int, D: int, H: int) -> None:
    c.lin(R * T, D, 2 * D)
    c.lin(R * T, D, D)
    c.attn(R, H, T, T, D // H)
    c.lin(R * T, D, D)


def lip_regressor(c: Count, rows: int, frames: int, D: int = 512, H: int = 4, ff: int = 1024, enc: int = 2,
                  dec: int = 4, verts: int = 1014) -> None:
    """``rows`` chunks of ``frames`` frames through the lip regressor."""
    n16 = resample_48k_to_16k(c, rows, frames * 1600) + 320
    tw = extractor(c, rows, n16)
    for k in range(2, 14):  # the aggregator: replication-padded convs keep the length
        c.conv(rows, 512, k, 512, tw)
    for _ in range(enc):
        _mha_self(c, rows, tw, D, H)
        c.lin(rows * tw, D, ff)
        c.lin(rows * tw, ff, D)
    for _ in range(dec):
        _mha_self(c, rows, frames, D, H)
        c.lin(rows * tw, D, D)
        c.lin(rows * tw, D, D)
        c.lin(rows * frames, D, D)
        c.attn(rows, H, frames, tw, D // H)
        c.lin(rows * frames, D, D)
        c.lin(rows * frames, D, ff)
        c.lin(rows * frames, ff, D)
    c.lin(rows * frames, D, verts)


def lip_vertices(c: Count, clips: int, frames: int, chunk: int = 120) -> None:
    full, rem = divmod(frames, chunk)
    if full:
        lip_regressor(c, clips * full, chunk)
    if rem:
        lip_regressor(c, clips, rem)


def guide_prenet(c: Count, rows: int, t: int, ch: int = 1024, blocks: int = 2) -> int:
    """The guide's dilated audio pre-net -> frames."""
    for _ in range(blocks):
        cin = ch
        for cout, d in ((max(256, ch), 1), (max(256, ch), 2), (max(128, ch), 3), (ch, 1), (ch, 2), (ch, 3)):
            t -= 2 * d
            c.conv(rows, cin, 3, cout, t)
            cin = cout
    c.conv(rows, ch, 1, ch, t)
    return t


def vq_decode(c: Count, rows: int, t: int, width: int, nfeats: int) -> None:
    tin = t + 7
    for cin, cout, k, d in ((width, width, 2, 1), (width, width, 2, 2), (width, width, 2, 3), (width, width, 2, 1),
                            (width, nfeats, 1, 1)):
        tin -= (k - 1) * d
        c.conv(rows, cin, k, cout, tin)
