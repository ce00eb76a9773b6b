"""Training-era sequence preparation helpers.

Vectorized counterparts of the reference's training-time encoders
(reference: ribodetector/data_loader/seq_encoder.py:95-123 center-crop +
reverse-complement pair, :148-162 sliding-window encoder, :42-53 labeled
whole-sequence loader). These are dead code in the reference's inference
path (SURVEY.md C2) but belong to the training workflow, so the package
ships working equivalents operating on token arrays (the JAX package's
module on this package's own encode and io).
"""

import numpy as np

from ribodetector_tpu_torch.encode.encoder import PAD_TOKEN, encode_batch

# A<->T, C<->G, U(->T)<->A handled at token level; pad stays pad
_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def reverse_complement_tokens(tokens, lengths=None):
    """Token-level reverse complement.

    With `lengths`, each row is reversed within its true length (padding
    stays at the tail); without, the full row is reversed.
    """
    comp = _COMPLEMENT[tokens]
    if lengths is None:
        return comp[:, ::-1]
    B, T = tokens.shape
    col = np.arange(T)
    src = lengths[:, None] - 1 - col[None, :]
    out = np.where(
        src >= 0,
        np.take_along_axis(comp, np.maximum(src, 0), axis=1),
        PAD_TOKEN,
    ).astype(np.uint8)
    return out


def get_read_rc_with_maxlen(seq, max_len=100):
    """Center-crop (or N-pad) a sequence and return (read, rc_read) strings.

    String-level parity with the reference helper (seq_encoder.py:95-108):
    long sequences take the centered max_len window; short ones are padded
    with 'N' AFTER the sequence, and the reverse complement is taken of the
    unpadded sequence then padded.
    """
    # full IUPAC complement (matches Bio.Seq.reverse_complement, which the
    # reference uses via seq_encoder.py:3,102)
    comp = str.maketrans(
        "ACGTUacgtuRYSWKMryswkmBVDHbvdhNn",
        "TGCAAtgcaaYRSWMKyrswmkVBHDvbhdNn",
    )
    seq_len = len(seq)
    if seq_len >= max_len:
        start = (seq_len - max_len) // 2
        read = seq[start : start + max_len]
        rc_read = read.translate(comp)[::-1]
    else:
        pad = "N" * (max_len - seq_len)
        read = seq + pad
        rc_read = seq.translate(comp)[::-1] + pad
    return read, rc_read


def encode_seq_windows(seq, step_size, max_len=100):
    """Sliding windows over a long sequence as token rows.

    Behavior parity with encode_seq_reads (seq_encoder.py:148-162): full
    windows at each step; a trailing partial window is kept (zero-padded)
    only if it covers more than max_len/2 of new sequence, then iteration
    stops.
    """
    tokens, _ = encode_batch([seq], max(len(seq), 1))
    row = tokens[0]
    seq_len = len(seq)
    out = []
    for i in range(0, max(seq_len, 1), step_size):
        if seq_len >= i + max_len:
            out.append(row[i : i + max_len])
        else:
            if seq_len > i + max_len / 2:
                win = np.full(max_len, PAD_TOKEN, np.uint8)
                win[: seq_len - i] = row[i:seq_len]
                out.append(win)
            break
    if not out:
        return np.empty((0, max_len), np.uint8)
    return np.stack(out)


def load_labeled_seqs(seq_file, label, max_len=100):
    """Labeled training pairs (read, revcomp) per input sequence.

    Counterpart of load_reads' labeled branch (seq_encoder.py:66-72): each
    sequence contributes itself and its reverse complement, center-cropped
    to max_len, each tagged with `label`.
    """
    from ribodetector_tpu_torch.io import parse_file

    out = []
    for record in parse_file(seq_file):
        read, rc = get_read_rc_with_maxlen(record[1], max_len=max_len)
        out.append((label, read))
        out.append((label, rc))
    return out
