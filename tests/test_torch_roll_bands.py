"""P2's exchange order (csrc/probes.cu namespace roll) modelled on the CPU.

The kernel splits the (112, 1152) tile into 4 bands of 28 rows, one a CTA,
and holds each band with a halo of rows from the neighbouring bands
(``roll_probe.HALO``): the cascade 2 rows above and 2 below, refreshed
every rep; a roll by one row on axis 0 (``roll axis0``, ``roll0 + add``)
4 rows above, refreshed every 4 reps; the axis-1 cases no halo. Between
exchanges a band's window steps alone: an axis-0 roll inside the window
leaves its edge row with a value from nowhere (a ghost), and a row that
reads a ghost becomes one. ``band_model`` runs every case so, with the
ghosts tracked, and the bands' rows joined equal ``roll_probe.plain`` bit
for bit at ``CHECK_REPS`` with no ghost in a band: the halo is deep
enough. One row less of halo, or one rep more an exchange, lets a ghost
into a band.
"""

import pytest
import torch

from tpuva_torch.probes import case_index, f32_to_i32, low_bytes, roll_probe
from test_torch_kernels import one_torch_thread  # noqa: F401

BANDS = roll_probe.CTAS
ROWS = roll_probe.SH // BANDS


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


def window_body(i, f, valid):
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


def band_model(x, case, reps, halo=None):
    """`reps` reps of case on the uint8 tile x as the kernel's bands run
    them: each band's window of (above, 28, below) rows, its halo copied
    from the neighbouring bands' rows at every exchange (halo: (above,
    below, reps an exchange), roll_probe.HALO's by default). Returns (the
    output tile, whether any band row ever held a ghost)."""
    i = case_index(roll_probe.CASES, case)
    above, below, period = halo or roll_probe.HALO.get(case, (0, 0, 0))
    tile = x.to(torch.int32).to(torch.float32)
    H = tile.shape[0]

    def window(q, state):
        rows = torch.arange(q * ROWS - above, (q + 1) * ROWS + below) % H
        return state[rows].clone()

    wins = [window(q, tile) for q in range(BANDS)]
    oks = [torch.ones(above + ROWS + below, dtype=torch.bool) for _ in range(BANDS)]
    ghost = False
    for r in range(reps):
        if r and period and r % period == 0:  # the exchange: neighbours' band rows
            state = torch.cat([w[above:above + ROWS] for w in wins])
            wins = [window(q, state) for q in range(BANDS)]
            oks = [torch.ones_like(ok) for ok in oks]
        for q in range(BANDS):
            wins[q], oks[q] = window_body(i, wins[q], oks[q])
            ghost |= not bool(oks[q][above:above + ROWS].all())
    out = torch.cat([w[above:above + ROWS] for w in wins])
    return low_bytes(f32_to_i32(out)), ghost


@pytest.mark.parametrize("case", [c.name for c in roll_probe.CASES])
def test_band_exchanges_match_plain(case):
    x = roll_probe.make_tile()
    for reps in roll_probe.CHECK_REPS:
        got, ghost = band_model(x, case, reps)
        assert not ghost, f"{case}: a ghost row reached a band at {reps} reps"
        assert torch.equal(got, roll_probe.plain(x, case, reps)), f"{case} at {reps} reps"


@pytest.mark.parametrize("case, halo", [
    ("k5 cascade (17 ops)", (1, 2, 1)), ("k5 cascade (17 ops)", (2, 1, 1)),
    ("roll axis0 (sublane)", (3, 0, 4)), ("roll axis0 (sublane)", (4, 0, 5)),
    ("roll0 + add", (4, 0, 5))])
def test_shallower_halo_lets_a_ghost_in(case, halo):
    """The halos are no deeper than the steps need: a row less, or a rep
    more between exchanges, lets a ghost into a band."""
    assert band_model(roll_probe.make_tile(), case, 9, halo)[1]
