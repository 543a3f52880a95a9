#!/usr/bin/env python3
"""The bf16 limits of ``tests/test_torch_lm.py``'s optional-block test
over many weight sets, on the CPU (the test module's own builders, each
comparison read rather than asserted).

For each variant of ``VARIANTS`` and each weight set (the reference's
``init_params`` seeded with ``hash(path)`` as a process at
PYTHONHASHSEED 0..7 and 36 computes it, and with the tests' crc32 of the
path), the largest share of the per-element limit ``assert_bf16`` reads
over the logits, prefill logits, k and v caches and a decode step, and
beside it the share of the test's earlier limit, 2^-7 of each tensor's
largest magnitude.  One JSON line:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_bf16_margins.py
"""
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
import lm_weights  # noqa: E402
import test_torch_lm as t  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

HASH_SEEDS = list(range(8)) + [36]


def main() -> int:
    shares = {}

    def record(got, want, what):
        got, want = t.f32(got), t.f32(want)
        err = np.abs(got - want)
        lim = 2.0 ** -8 * (np.abs(want).max() + np.abs(got)) + \
            2.0 ** -7 * np.abs(want)
        row = shares.setdefault(what.split()[0], [0.0, 0.0])
        row[0] = max(row[0], float((err / lim).max()))
        row[1] = max(row[1], float(err.max() / (2.0 ** -7 *
                                                np.abs(want).max())))
    for weights in HASH_SEEDS + ["crc32"]:
        for variant in sorted(t.VARIANTS):
            jcfg = t.optional_model(variant)[0]
            seeds = (lm_weights.crc32_seed if weights == "crc32" else
                     lm_weights.hash_seeds(JL.tree_paths(
                         JT.model_pspecs(jcfg)), weights).__getitem__)
            with lm_weights.path_seeds(seeds):
                t.check_optional_blocks(variant, *t.optional_model(variant),
                                        check=record)
    print(json.dumps({"weights": HASH_SEEDS + ["crc32"],
                      "per_element_share": {k: v[0] for k, v in
                                            shares.items()},
                      "max_relative_2m7_share": {k: v[1] for k, v in
                                                 shares.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
