"""Dataset wrappers over read collections.

API counterparts of the reference's map-style torch Datasets
(reference: ribodetector/data_loader/dataset.py:7-29 SeqData /
PairedReadData; the Iterable* variants at dataset.py:32-95 are dead AND
buggy -- they iterate over a bound method object -- and are deliberately
not reproduced). These wrappers are framework-free: the engine batches with
numpy views, so a Dataset here is just indexed access plus batch iteration
for users porting reference code.
"""

import numpy as np


class SeqData:
    """Indexable view over a list of parsed records."""

    def __init__(self, reads):
        self.reads = reads

    def __len__(self):
        return len(self.reads)

    def __getitem__(self, index):
        return self.reads[index]

    def batches(self, batch_size):
        for start in range(0, len(self.reads), batch_size):
            yield self.reads[start : start + batch_size]


class PairedReadData:
    """Indexable view over ([r1 records], [r2 records]); item i is the pair
    (r1[i], r2[i]). Like the reference (dataset.py:19-29), length follows
    R1; use min() lengths upstream for unequal files (quirk #8)."""

    def __init__(self, paired_reads):
        self.r1, self.r2 = paired_reads

    def __len__(self):
        return len(self.r1)

    def __getitem__(self, index):
        return self.r1[index], self.r2[index]

    def batches(self, batch_size):
        for start in range(0, len(self.r1), batch_size):
            yield (
                self.r1[start : start + batch_size],
                self.r2[start : start + batch_size],
            )


def train_val_split(n, val_fraction, seed=0):
    """Shuffled train/validation index split.

    Counterpart of the reference's BaseDataLoader sampler split
    (ribodetector/base/base_data_loader.py:31-55): a fraction in [0,1) or an
    absolute count; validation indices come off the front of the shuffled
    permutation, mirroring idx_full[0:len_valid].
    """
    idx = np.random.default_rng(seed).permutation(n)
    if val_fraction == 0:
        return idx, np.empty(0, np.int64)
    if isinstance(val_fraction, int):
        assert 0 < val_fraction < n, (
            "validation set size is configured to be larger than entire dataset."
        )
        len_valid = val_fraction
    else:
        len_valid = int(n * val_fraction)
    return idx[len_valid:], idx[:len_valid]
