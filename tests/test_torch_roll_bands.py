"""P2's and P3's exchange order (csrc/probes.cu namespaces roll and i16)
modelled on the CPU.

Both kernels split the (112, 1152) tile into 4 bands of 28 rows, one a CTA,
and hold each band with a halo of rows from the neighbouring bands (the
probe's ``HALO``): the k = 5 cascade (P2's and P3's four cases) 2 rows above
and 2 below, refreshed every rep; a roll by one row on axis 0 (``roll
axis0``, ``roll0 + add``) 4 rows above, refreshed every 4 reps; P2's axis-1
cases no halo. Between exchanges a band's window steps alone: an axis-0
roll inside the window leaves its edge row with a value from nowhere (a
ghost), and a row that reads a ghost becomes one. ``band_model`` runs every
case so, with the ghosts tracked, and the bands' rows joined equal the
probe's ``plain`` bit for bit at ``CHECK_REPS`` with no ghost in a band: the
halo is deep enough. One row less of halo, or one rep more an exchange,
lets a ghost into a band.

P3's int16 and uint16 cases run packed: rows 2 i and 2 i + 1 of a column in
one 32-bit word (its low and high halfword), modelled as int64 words. An
axis-1 roll moves whole words; an axis-0 roll by a row is the funnel shift
of a word and the word above or below; the rescale takes each halfword's
high byte, sign-replicated (int16) or zero (uint16). uint16 adds a word by
one plain 32-bit add: no halfword sum passes 255 x 2^8 = 65,280, so no
carry crosses. int16 needs the halfword-safe add: its rescale sign-extends,
and a plain add carries across.
"""

import pytest
import torch

from tpuva_torch.probes import case_index, f32_to_i32, i16_probe, low_bytes, roll_probe
from test_torch_kernels import one_torch_thread  # noqa: F401

PACKED = ("int16", "uint16")
WORD = 0xFFFFFFFF


def window_roll(f, valid, shift, dim):
    """torch.roll of a band's window, and which of its rows stay real: on
    axis 1 the whole row is there; on axis 0 the row rolled in at the
    window's edge is a ghost."""
    if dim == 1:
        return torch.roll(f, shift, 1), valid
    if shift not in (1, -1):
        raise ValueError("the kernel's axis-0 steps roll by one row either way")
    return torch.roll(f, shift, 0), torch.roll(valid, shift, 0) & (
        torch.arange(len(valid)) != (0 if shift == 1 else len(valid) - 1))


def word_roll0(f, valid, shift):
    """roll(f, shift, axis=0) of a packed window, words f (n, W), valid (n,
    2) by halfword: the funnel shift of each word and the one above (1) or
    below (-1); the halfword rolled in at the window's edge is a ghost."""
    if shift == 1:  # (the above's high half, this low half)
        g = (torch.roll(f, 1, 0) >> 16 | f << 16) & WORD
        ok = torch.stack([torch.roll(valid[:, 1], 1, 0), valid[:, 0]], 1)
        ok[0, 0] = False
    elif shift == -1:  # (this high half, the below's low half)
        g = (f >> 16 | torch.roll(f, -1, 0) << 16) & WORD
        ok = torch.stack([valid[:, 1], torch.roll(valid[:, 0], -1, 0)], 1)
        ok[-1, 1] = False
    else:
        raise ValueError("the kernel's axis-0 steps roll by one row either way")
    return g, ok


def add_halves(a, b):
    """Two packed 16-bit sums, each wrapped in its halfword (__vadd2)."""
    return ((a + b) & 0xFFFF) | (((a >> 16) + (b >> 16)) & 0xFFFF) << 16


def add_words(a, b):
    """One plain 32-bit add of two packed words: a carry out of the low
    halfword lands in the high one."""
    return (a + b) & WORD


def high_bytes(v, signed):
    """Each halfword's high byte in its low byte, sign-replicated or zero
    above: the packed rescale's byte permute."""
    lo, hi = (v >> 8) & 0xFF, (v >> 24) & 0xFF
    if signed:
        lo, hi = lo | (lo >= 0x80) * 0xFF00, hi | (hi >= 0x80) * 0xFF00
    return lo | hi << 16


def pack(rows):
    """Halfword rows (2 n, W) -> words (n, W): rows 2 i low, 2 i + 1 high."""
    return rows[0::2] | rows[1::2] << 16


def unpack(words):
    rows = torch.empty((2 * len(words), words.shape[1]), dtype=torch.int64)
    rows[0::2], rows[1::2] = words & 0xFFFF, words >> 16
    return rows


def i16_add(case):
    """The sum of P3's case in its kernel's form."""
    if case in PACKED:
        return add_halves if case == "int16" else add_words
    return torch.add


def i16_cascade(case, f, valid, add):
    """One rep of P3's case on a window in its kernel's form (the packed
    cases as words): the 16-op cascade with the case's add, then the
    rescale; the value and which rows (halfwords) stay real."""
    for dim in (1, 0):
        for shift in (1, 1, -1, -1):
            if case in PACKED and dim == 0:
                g, ok = word_roll0(f, valid, shift)
            else:
                g, ok = window_roll(f, valid, shift, dim)
            f, valid = add(f, g), valid & ok
    if case == "float32":
        return f * 2.0**-8, valid
    if case == "int32":
        return f >> 8, valid
    return high_bytes(f, case == "int16"), valid


def roll_body(i, f, valid):
    """roll_probe.body on a band's window (a roll by H - 1 rows is one
    row up): the value and the rows that stay real."""
    eps = torch.tensor(1e-7, dtype=torch.float32)
    if i in (0, 1, 3, 4, 6, 7):  # rows alone
        return roll_probe.body(i, f) + eps, valid
    if i == 2:
        g, ok = window_roll(f, valid, 1, 0)
        return g + eps, ok
    if i == 5:
        g, ok = window_roll(f, valid, 1, 0)
        return f + g + eps, valid & ok
    for dim in (1, 0):
        for shift in (1, 1, -1, -1):
            g, ok = window_roll(f, valid, shift if dim == 0 else shift % f.shape[1], dim)
            f, valid = f + g, valid & ok
    return f * 2.0**-8 + eps, valid


class Form:
    """A probe case's tile in its kernel's form: load(x) the u8 tile as the
    kernel's rows (P3's packed cases: halfword values), window(rows) a
    window's words and its validity, rows(words) back, out(rows) the u8
    output, step(words, valid) one rep."""

    def __init__(self, probe, case):
        self.packed = probe is i16_probe and case in PACKED
        if probe is roll_probe:
            i = case_index(roll_probe.CASES, case)
            self.step = lambda f, ok: roll_body(i, f, ok)
            self.load = lambda x: x.to(torch.int32).to(torch.float32)
        else:
            case_index(i16_probe.CASES, case)
            add = i16_add(case)
            self.step = lambda f, ok: i16_cascade(case, f, ok, add)
            dtype = {"float32": torch.float32, "int32": torch.int32}.get(case, torch.int64)
            self.load = lambda x: x.to(torch.int32).to(dtype)
        self.float = probe is roll_probe or case == "float32"

    def window(self, rows):
        if self.packed:
            return pack(rows), torch.ones((len(rows) // 2, 2), dtype=torch.bool)
        return rows.clone(), torch.ones(len(rows), dtype=torch.bool)

    def rows(self, words):
        return unpack(words) if self.packed else words

    def out(self, rows):
        return low_bytes(f32_to_i32(rows) if self.float else rows.to(torch.int64))


def band_model(probe, x, case, reps, halo=None, bands=None):
    """`reps` reps of the probe's case on the uint8 tile x as the kernel's
    bands run them: each of `bands` bands (the probe's CTAS) a window of
    (above, rows, below) tile rows, its halo copied from the neighbouring
    bands' rows at every exchange (halo: (above, below, reps an exchange),
    the probe's HALO by default; a packed case's in whole words, so even).
    Returns (the output tile, whether any band row ever held a ghost)."""
    form = Form(probe, case)
    above, below, period = halo or probe.HALO.get(case, (0, 0, 0))
    bands = bands or probe.CTAS
    H = x.shape[0]
    rows = H // bands
    if form.packed and (above % 2 or below % 2 or rows % 2):
        raise ValueError("a packed window is whole words")

    def windows(state):
        return [form.window(state[torch.arange(q * rows - above, (q + 1) * rows + below) % H])
                for q in range(bands)]

    def band_rows(w):
        return form.rows(w)[above:above + rows]

    wins = windows(form.load(x))
    ghost = False
    for r in range(reps):
        if r and period and r % period == 0:  # the exchange: neighbours' band rows
            wins = windows(torch.cat([band_rows(w) for w, _ in wins]))
        for q in range(bands):
            wins[q] = form.step(*wins[q])
            ok = wins[q][1].reshape(-1)  # a tile row each
            ghost |= not bool(ok[above:above + rows].all())
    return form.out(torch.cat([band_rows(w) for w, _ in wins])), ghost


CASES = [(roll_probe, c.name) for c in roll_probe.CASES] + [
    (i16_probe, c.name) for c in i16_probe.CASES]


def case_id(probe, case):
    return case if probe is roll_probe else f"i16 {case}"


@pytest.mark.parametrize("probe, case", CASES, ids=[case_id(*c) for c in CASES])
def test_band_exchanges_match_plain(probe, case):
    x = probe.make_tile()
    for reps in probe.CHECK_REPS:
        got, ghost = band_model(probe, x, case, reps)
        assert not ghost, f"{case}: a ghost row reached a band at {reps} reps"
        assert torch.equal(got, probe.plain(x, case, reps)), f"{case} at {reps} reps"


SHALLOW = [
    (roll_probe, "k5 cascade (17 ops)", (1, 2, 1)), (roll_probe, "k5 cascade (17 ops)", (2, 1, 1)),
    (roll_probe, "roll axis0 (sublane)", (3, 0, 4)), (roll_probe, "roll axis0 (sublane)", (4, 0, 5)),
    (roll_probe, "roll0 + add", (4, 0, 5))] + [
    (i16_probe, c.name, h) for c in i16_probe.CASES
    for h in ([(1, 2, 1), (2, 1, 1)] if c.name not in PACKED else [(0, 2, 1), (2, 0, 1)])]


@pytest.mark.parametrize("probe, case, halo", SHALLOW,
                         ids=[f"{case_id(p, c)}-halo{n}" for n, (p, c, _) in enumerate(SHALLOW)])
def test_shallower_halo_lets_a_ghost_in(probe, case, halo):
    """The halos are no deeper than the steps need: a row (a packed case: a
    word row) less, or a rep more between exchanges, lets a ghost into a
    band."""
    assert band_model(probe, probe.make_tile(), case, 9, halo)[1]


def packed_tile(x, case, reps, add):
    """`reps` reps of P3's packed case on the whole uint8 tile x, as words
    with the given add: the tile is one window, so its rolls wrap as the
    tile's."""
    f = pack(x.to(torch.int64))
    ok = torch.ones((len(f), 2), dtype=torch.bool)
    for _ in range(reps):
        f, ok = i16_cascade(case, f, ok, add)
    return low_bytes(unpack(f))


@pytest.mark.parametrize("tile", ["file", "all 255"])
def test_uint16_plain_word_add_is_exact(tile):
    """uint16's halfword sums stay below 2^16 (at most 255 x 256 = 65,280
    before the rescale, which brings every value back to 255 or less), so
    one plain 32-bit add a packed word gives plain's bytes: on the file's
    tile and on the tile that reaches the largest sum."""
    x = i16_probe.make_tile()
    if tile == "all 255":
        x = torch.full_like(x, 255)
    for reps in i16_probe.CHECK_REPS:
        assert torch.equal(packed_tile(x, "uint16", reps, add_words),
                           i16_probe.plain(x, "uint16", reps)), f"uint16 at {reps} reps"


def test_int16_needs_the_halfword_add():
    """int16's rescale sign-extends into the high byte, so from the second
    rep a low halfword like 0xFFxx carries into the high one under a plain
    32-bit add: its bytes differ from plain's at 2 and 3 reps, and the
    halfword-safe add's do not. At 1 rep every value is a u8, and no carry
    crosses."""
    x = i16_probe.make_tile()
    for reps in (1, 2, 3):
        want = i16_probe.plain(x, "int16", reps)
        assert torch.equal(packed_tile(x, "int16", reps, add_halves), want)
        assert torch.equal(packed_tile(x, "int16", reps, add_words), want) == (reps == 1)
