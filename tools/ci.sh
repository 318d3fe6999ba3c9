#!/usr/bin/env bash
# CI entry point: clean-checkout validation.
#   tools/ci.sh [quick]
# Steps: (1) build the wheel and import-smoke it from an isolated target,
# (2) build the C++ golden-oracle CLI when /root/reference is present,
# (3) run the CPU test suite (8 virtual devices, the GPU kernels in Pallas
# interpret mode where a test asks for it).  GPU parity is a separate
# stage on a machine with a card:
#   JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q && python chip_smoke.py
set -euo pipefail
cd "$(dirname "$0")/.."

export JAX_PLATFORMS=cpu

echo "== wheel =="
rm -rf .ci-scratch/wheel && mkdir -p .ci-scratch/wheel
pip wheel --no-build-isolation --no-deps -w .ci-scratch/wheel . >/dev/null
rm -rf .ci-scratch/site && mkdir -p .ci-scratch/site
pip install --no-deps --target .ci-scratch/site .ci-scratch/wheel/*.whl >/dev/null
(cd /tmp && PYTHONPATH="$OLDPWD/.ci-scratch/site" python - << 'EOF'
from mgl_tpu.api import OverhangStrategy, SmithWatermanAligner, SWParameters
r = SmithWatermanAligner().align(b"ACGTACGTACGT", b"ACGTACGT",
                                 SWParameters(25, -50, 110, 6),
                                 OverhangStrategy.SOFTCLIP)
assert (r.cigar, r.offset) == ("8M", 4), r
print("wheel smoke OK:", r)
EOF
)

if [ -d /root/reference ]; then
  echo "== oracle =="
  tools/oracle/build.sh >/dev/null
else
  echo "== oracle skipped (no /root/reference) =="
fi

echo "== cpu suite =="
if [ "${1:-}" = "quick" ]; then
  python -m pytest tests/ -x -q -k "not scale"
else
  python -m pytest tests/ -q
fi
echo "CI OK"
