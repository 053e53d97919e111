#!/bin/bash
# Mutation check of the PR 15 modules' true-f32 scopes, on a machine with a
# GPU: for each case, copy the package and its tests into a temporary
# directory, drop one `full_f32` scope there, and run the card test that
# must catch it. Every line should end "1 failed" (or more). Run from the
# repository root:  bash tools/tf32_mutants.sh
set -u
root=$(pwd)
for spec in "uq/knn.py|with torch.no_grad(), full_f32():|with torch.no_grad():|test_knn_similarities" \
            "uq/laplace.py|    with torch.no_grad(), full_f32():\n        p = |    with torch.no_grad():\n        p = |test_laplace" \
            "core/precision.py|with full_f32(), torch.enable_grad():|with torch.enable_grad():|test_fgsm_gradient_and_refine_step" \
            "uq/swag.py|    with torch.no_grad(), full_f32():\n        return torch.stack|    with torch.no_grad():\n        return torch.stack|test_swag_sample_and_bma and plain" \
            "attacks/fgsm.py|    with full_f32():\n        ce_clean|    if True:\n        ce_clean|test_adversarial_train_step"; do
  IFS='|' read -r file old new test <<< "$spec"
  mut=$(mktemp -d)
  cp -r "$root/imagetransformations_tpu_torch" "$root/tests" "$root/pyproject.toml" "$mut/"
  python3 - "$mut/imagetransformations_tpu_torch/$file" "$old" "$new" <<'PY'
import sys
path, old, new = sys.argv[1], sys.argv[2].replace("\\n", "\n"), sys.argv[3].replace("\\n", "\n")
src = open(path).read()
assert old in src, (path, old)
open(path, "w").write(src.replace(old, new, 1))
PY
  (cd "$mut" && python3 -m pytest tests/test_torch_cuda_uq.py -q -k "$test" -p no:cacheprovider 2>&1 \
     | tail -1 | sed "s|^|mutant $file ($test): |")
  rm -rf "$mut"
done
