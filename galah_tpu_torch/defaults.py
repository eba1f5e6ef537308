"""Default operating points.

Parity with the reference's constants (reference: src/lib.rs:78-92) plus
the TPU-native engine's own sketching defaults.

The port's own copy of galah_tpu/defaults.py, so that the port imports
nothing of galah_tpu: same behaviour, file formats and numerics.
"""

# --- Reference-parity defaults (src/lib.rs:78-92) ---
DEFAULT_ANI = 95.0
DEFAULT_PRETHRESHOLD_ANI = 90.0
DEFAULT_ALIGNED_FRACTION = 15.0
DEFAULT_FRAGMENT_LENGTH = 3000
DEFAULT_QUALITY_FORMULA = "Parks2020_reduced"

# The reference dispatches to external skani/fastANI/finch
# (src/lib.rs:83-86). Here 'native' is the TPU-native engine which is both
# a preclusterer and a clusterer; 'finch' is the exact-parity Mash MinHash
# preclusterer; 'skani'/'fastani' are subprocess passthroughs retained for
# users with those binaries installed.
DEFAULT_PRECLUSTER_METHOD = "native"
PRECLUSTER_METHODS = ("native", "finch", "skani")
DEFAULT_CLUSTER_METHOD = "native"
CLUSTER_METHODS = ("native", "skani", "fastani")

DEFAULT_QUALITY_METHOD = "checkm2"
QUALITY_METHODS = ("checkm2",)
DEFAULT_RRNA_METHOD = "barrnap"
RRNA_METHODS = ("barrnap",)
DEFAULT_TRNA_METHOD = "trnascan"
TRNA_METHODS = ("trnascan",)

# Finch/Mash-parity sketch parameters (src/finch.rs:55-61)
MASH_NUM_HASHES = 1000
MASH_KMER_LENGTH = 21
MASH_HASH_SEED = 0

# skani's accuracy envelope: the reference refuses thresholds below 85%
# ANI (src/skani.rs:116-121). The native engine keeps the same guard for
# its skani-compatible modes.
MIN_SUPPORTED_PRECLUSTER_ANI = 85.0

# --- Native engine sketch defaults (TPU-first; no reference analog) ---
# Native estimator k-mer length: k=15 balances sensitivity at the 80%
# fragment-identity cutoff against specificity near 100% ANI.
NATIVE_KMER_LENGTH = 15
# Genome-level FracMinHash: keep hashes h < 2**64 / scale.
NATIVE_SCALE = 200           # ~1 hash kept per 200bp (5Mb genome -> ~25k)
NATIVE_SMALL_SCALE = 10      # --small-genomes: denser sampling for <20kb seqs
# Indicator width (bits) for the genome-level sketch used by the MXU
# screen matmul. ~10% load factor at the default scale.
NATIVE_PREFILTER_BITS = 1 << 18
NATIVE_SMALL_PREFILTER_BITS = 1 << 15
# Fragment-level sampling for the high-precision ANI stage.
NATIVE_FRAGMENT_SCALE = 8    # ~1 hash kept per 8bp within each fragment
NATIVE_SMALL_FRAGMENT_SCALE = 2
# A fragment counts as "aligned" if its estimated identity passes this.
NATIVE_FRAGMENT_MIN_IDENTITY = 0.80
# Genome-level membership bitmap width for the fragment-containment ANI
# stage (bits). Load factor is corrected for analytically.
NATIVE_MEMBER_BITS = 1 << 22
# 2^16 keeps small-contig load factors modest (a 20kb contig at
# fragment scale 2 is ~15% — corrected for) and lets fragment streams
# travel as uint16.
NATIVE_SMALL_MEMBER_BITS = 1 << 16
# Screen-stage safety margin: a candidate survives the screen if its
# containment exceeds margin * min_af * (ani/100)**k. The prefilter
# bitmap is widened whenever that cutoff would sit under 4x the
# collision-noise std (engines/native.py::_widen_for_low_af).
NATIVE_SCREEN_MARGIN = 0.5

# --ani-semantics: how the native engine's ANI thresholds relate to the
# reference toolchain's. "window" (default) compares the estimator's
# own event-inclusive ANI against the thresholds verbatim;
# "skani-calibrated" shifts thresholds by the measured, theory-pinned
# indel bias so `--ani X` reproduces gap-excluded (skani-style) ANI
# cuts on indel-bearing real genomes. The bias of a k-mer-window
# estimator vs gap-excluded ANI is -p_indel*(k+len-1)/k per unit
# divergence (benchmarks/RESULTS.md round 3; tests/
# test_estimator_stress.py pins measurement to theory); the calibration
# assumes the documented typical prokaryote indel load below.
# Reference threshold semantics: src/skani.rs:718-788 (gap-excluded
# chaining ANI), src/lib.rs:78-92 (default thresholds tuned for it).
ANI_SEMANTICS = ("window", "skani-calibrated")
DEFAULT_ANI_SEMANTICS = "window"
CALIBRATION_INDEL_EVENTS_PER_SUB = 0.1   # ~1 indel per 10 substitutions
CALIBRATION_MEAN_INDEL_LEN = 3.0
