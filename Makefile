# One-command entry points (the reference ships a CI pipeline,
# /root/reference/.github/workflows/CI.yml:17-68; this is its local face).
#
# `make test` runs the hermetic CPU suite on an 8-virtual-device mesh —
# the same multi-rank-on-one-node strategy as the reference's
# `mpiexec -n 4` test harness (SURVEY.md §4).

PY ?= python

.PHONY: test bench-smoke bench smoke entry lint all

all: test bench-smoke

test:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -m pytest tests/ -q

# small-problem end-to-end benchmark on local CPU (CI-sized); bench.py
# runs on the CPU only when JAX_PLATFORMS=cpu is set by hand
bench-smoke:
	JAX_PLATFORMS=cpu MGB_BENCH_L=3 $(PY) bench.py

# the headline benchmark on one GPU (exits non-zero without one)
bench:
	$(PY) bench.py

# GPU smoke test: kernels vs references, then fem2d L=7 on one card
smoke:
	$(PY) chip_smoke.py

# driver entry points: single-chip compile check + 8-device virtual dry run
entry:
	$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun ok')"

lint:
	$(PY) -m pyflakes multigridbarrier_tpu tests tools bench.py __graft_entry__.py 2>/dev/null \
	  || $(PY) -m py_compile $$(git ls-files '*.py')
