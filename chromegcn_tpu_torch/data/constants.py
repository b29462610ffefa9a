"""Vocabulary, chromosome split and window geometry (port of
chromegcn_tpu/data/constants.py:21-46, copied: the JAX package's modules
import jax).

The canonical DNA vocabulary is alphabetical; every dataset file carries
its own vocabulary, and the sequence ops derive their permutations from it,
so the reference's frequency-ordered vocabulary (reference:
data/create_torch_data.py:52-90) works as well.
"""

# Canonical DNA vocabulary: token id per base symbol.
SRC_VOCAB = {"a": 0, "c": 1, "g": 2, "t": 3, "n": 4}
SRC_VOCAB_SIZE = 5

# Watson-Crick complement at the symbol level ('n' maps to itself).
COMPLEMENT = {"a": "t", "t": "a", "c": "g", "g": "c", "n": "n"}

# Chromosome split contract (reference: data/create_data.py:44-45).
VALID_CHROMS = ("chr3", "chr12", "chr17")
TEST_CHROMS = ("chr1", "chr8", "chr21")
ALL_CHROMS = tuple(f"chr{i}" for i in range(1, 23))
TRAIN_CHROMS = tuple(
    c for c in ALL_CHROMS if c not in VALID_CHROMS and c not in TEST_CHROMS
)

# Window geometry (reference: data/create_data.py:17-18).
WINDOW_SIZE = 1000
EXTENDED_WINDOW_SIZE = 2000
