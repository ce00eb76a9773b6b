"""The Caduceus cell's control: the plain reference's scan
(reference/caduceus.py ``selective``) at the precision just below the
configuration's, "bf16_state" (the scan state and its exp held in bf16),
put in the place of the program's scan, so that a whole run of the cell
(core.run_cell) judges it by the cell's own check. Everything else of the
program runs as it is: its in-projection, conv, x_proj (the control's scan
reads the program's [delta, B, C]), out-projection, norms, pool and head.

On the card it stands for ``ops.caduceus_cuda.scan_cuda`` (cad_scan_kernel);
on the CPU, for ``models.caduceus.scan_plain`` (the CPU tests' planted
fault). ``benchmark/tests/test_bench_caduceus.py`` runs it; the measured
runs never do.
"""

import math
from contextlib import ExitStack, contextmanager

from harness.hooks import patched
from reference import caduceus as cref


def gated_bf16_state(xz, dbc, xc, lengths, w_dt, b_dt, A, d):
    """Both directions' dt, scan (state and exp in bf16) and D skip, and the
    gate: xz [N, T, 2E] (z its second half), dbc [2, N, T, R + 2S] and xc
    [2, N, T, E] in the program's original coordinates (the reverse
    direction's conv looking ahead), per-direction weights w_dt [2, R, E],
    b_dt and d [2, E], A [2, E, S] -> [N, T, E] fp32, zero past each row's
    length."""
    import torch

    L = lengths.long()
    E = xz.shape[-1] // 2
    dbc, xc = dbc.float(), xc.float()
    yf = cref.selective(xc[0], dbc[0], w_dt[0], b_dt[0], A[0], d[0], "bf16_state")
    yr = cref.selective(cref._reverse(xc[1], L), cref._reverse(dbc[1], L), w_dt[1], b_dt[1],
                        A[1], d[1], "bf16_state")
    g = (yf + cref._reverse(yr, L)) * torch.nn.functional.silu(xz[..., E:].float())
    inside = torch.arange(xz.shape[1], device=xz.device)[None, :, None] < L[:, None, None]
    return torch.where(inside, g, 0.0)


def scan_cuda(xz, dbc, lengths, conv_w, conv_b, w_dt, b_dt, a2, d):
    """ops.caduceus_cuda.scan_cuda's arguments and result (bf16), from the
    reference: the conv recomputed in fp32 from the bf16 x, as the kernel
    does; a2 is -exp(A_log) log2(e)."""
    import torch

    L = lengths.long()
    E = xz.shape[-1] // 2
    x = xz[..., :E].float()
    xc = torch.stack([cref.conv(x, conv_w[0], conv_b[0]),
                      cref._reverse(cref.conv(cref._reverse(x, L), conv_w[1], conv_b[1]), L)])
    g = gated_bf16_state(xz, dbc, xc, lengths, w_dt, b_dt, a2 * math.log(2.0), d)
    return g.to(torch.bfloat16)


def scan_plain(xz, dbc, xc, lengths, w_dt, b_dt, a_log, d):
    """models.caduceus.scan_plain's arguments and result (fp32)."""
    import torch

    return gated_bf16_state(xz, dbc, xc, lengths, w_dt, b_dt, -torch.exp(a_log), d)


@contextmanager
def reference_in_place():
    import ribodetector_tpu_torch.models.caduceus as plain
    import ribodetector_tpu_torch.ops.caduceus_cuda as card

    with ExitStack() as stack:
        stack.enter_context(patched(card, "scan_cuda", scan_cuda))
        stack.enter_context(patched(plain, "scan_plain", scan_plain))
        yield
