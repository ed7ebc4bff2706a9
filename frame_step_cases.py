"""Edge cases of the tracker frame step's greedy order for
``csrc/frame_step.cu``'s packed (row minimum, id) keys, applied to the
inputs of ``ops/frame_step.py::match_and_register`` in place.
``tests/test_torch_frame_step.py`` and ``chip_smoke.py`` (phase 30) both
draw their key edges from here.
"""

import torch

INT_MAX = 2 ** 31 - 1
#: NaN payloads: quiet, negative quiet, signalling, negative with a payload
NAN_BITS = (0x7fc00000, 0xffc00000, 0x7f800001, 0xfff00abc)
#: ``key_edges``' cases
KEY_EDGES = ('signed_zeros', 'nan_payloads', 'int_limits', 'equal_keys')


def key_edges(edge, state, row_min, cand):
    """Rewrite the active slots' row minima, ids or candidates of video 0
    (in place) for a key edge case: ``signed_zeros`` (-0.0 beside +0.0,
    the sort's equal keys, and +inf), ``nan_payloads`` (NaNs of several
    payloads and signs, one key after +inf), ``int_limits`` (ids at
    INT_MIN and INT_MAX beside their neighbours, a third of the row
    minima equal), ``equal_keys`` (pairs of active slots far apart with
    the same id, row minimum and column: only the slot decides which one
    wins it)."""
    on = torch.nonzero(state['active'][0]).flatten()
    n = len(on)
    if edge == 'signed_zeros':
        row_min[0, on[::2]] = 0.0
        row_min[0, on[1::2]] = -0.0
        row_min[0, on[::5]] = float('inf')
    elif edge == 'nan_payloads':
        bits = torch.tensor(NAN_BITS, dtype=torch.int64).to(
            torch.int32).view(torch.float32).to(row_min.device)
        row_min[0, on[::2]] = bits.repeat(n)[:len(on[::2])]
        row_min[0, on[1::4]] = float('inf')
    elif edge == 'int_limits':
        ids = state['ids'][0]
        dev = ids.device
        ids[on[:n // 4]] = -2 ** 31 + torch.arange(n // 4, dtype=torch.int32,
                                                   device=dev)
        ids[on[n // 4:n // 2]] = INT_MAX - torch.arange(
            n // 2 - n // 4, dtype=torch.int32, device=dev)
        row_min[0, on[::3]] = float(row_min[0, on[0]])
    elif edge == 'equal_keys':
        ids = state['ids'][0]
        half = n // 2
        ids[on[half:2 * half]] = ids[on[:half]]
        row_min[0, on[half:2 * half]] = row_min[0, on[:half]]
        cand[0, on[half:2 * half]] = cand[0, on[:half]]
    else:
        raise ValueError('unknown key edge {}'.format(edge))
