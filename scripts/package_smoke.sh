#!/bin/bash
# CI-style packaging gate (reference: .github/workflows/python-app.yml runs
# its smoke test against the built wheel AND sdist): build (or accept) an
# artifact, install it into a clean target dir, and import/exercise the
# package from OUTSIDE the repo.
#
# Usage:
#   scripts/package_smoke.sh                  # build a wheel here, smoke it
#   scripts/package_smoke.sh dist/x.whl       # smoke a prebuilt wheel
#   scripts/package_smoke.sh dist/x.tar.gz    # smoke a prebuilt sdist
set -euo pipefail
cd "$(dirname "$0")/.."

artifact="${1:-}"
if [ -z "$artifact" ]; then
  rm -rf build/pkg_smoke dist_build
  python -m pip wheel . --no-deps --no-build-isolation -w dist_build -q
  artifact=$(ls dist_build/*.whl)
fi

tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
case "$artifact" in
  *.whl)
    python -m pip install --no-deps -q --target "$tmp" "$artifact"
    ;;
  *.tar.gz)
    # sdist: pip builds a wheel from it first (needs setuptools on path;
    # --no-build-isolation keeps the zero-egress env happy).
    python -m pip install --no-deps --no-build-isolation -q --target "$tmp" "$artifact"
    ;;
  *)
    echo "unknown artifact type: $artifact" >&2
    exit 2
    ;;
esac

cd /tmp
PYTHONPATH="$tmp" python - <<'PY'
import jax

# The smoke checks packaging, not the accelerator: pin the CPU backend
# before any backend touch.
jax.config.update("jax_platforms", "cpu")
import numpy as np
import raw2film_tpu
from raw2film_tpu import Processor, load_film_stocks

stocks = load_film_stocks()
assert len(stocks) >= 26, len(stocks)
proc = Processor()
img = np.abs(np.random.default_rng(0).normal(0.2, 0.1, (3, 48, 72))).astype(np.float32)
out = proc.process(img, "Kodak Portra 400", print_film=None, grain=0,
                   halation=False, sharpness=False, half_size=False, max_scale=None)
assert out.shape == (48, 72, 3) and out.dtype == np.uint8
print(f"package smoke OK: {len(stocks)} stocks, render {out.shape}")
PY
echo "smoke passed: $artifact"
