#!/usr/bin/env python3
"""The bf16 limits of ``tests/test_torch_train_grads.py`` over ten weight
sets, on the CPU (the test module's own ``compare``, each comparison read
rather than asserted).

For each arch of the bf16 test and each weight set (the reference's
``init_params`` from ``PRNGKey(key)``, key 0..9, crc32 path seeds, zero
leaves redrawn from numpy's generator seeded with the key, a batch from
the same generator), the largest share of the test's limits: the loss's
relative error over ``BF16_LOSS`` and each gradient leaf's error over its
largest magnitude, over ``BF16_LEAF``, with the worst leaf's name.  One
JSON line:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_bf16_margins.py
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
import lm_weights  # noqa: E402
import test_torch_train_grads as t  # noqa: E402

KEYS = range(10)


def main() -> int:
    out = {}
    with lm_weights.path_seeds(lm_weights.crc32_seed):
        for arch in t.ARCHS[:3]:
            row = {"loss_share": 0.0, "leaf_share": 0.0, "worst_leaf": None}
            for key in KEYS:
                loss_err, errs, _, _ = t.compare(arch, "bfloat16", key)
                worst = max(errs, key=errs.get)
                row["loss_share"] = max(row["loss_share"],
                                        loss_err / t.BF16_LOSS)
                if errs[worst] / t.BF16_LEAF > row["leaf_share"]:
                    row["leaf_share"] = errs[worst] / t.BF16_LEAF
                    row["worst_leaf"] = f"{worst} (key {key})"
            out[arch] = row
    print(json.dumps({"weight_sets": len(KEYS), "bf16_loss": t.BF16_LOSS,
                      "bf16_leaf": t.BF16_LEAF, "archs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
