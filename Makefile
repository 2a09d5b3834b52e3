# Convenience entry points (see CLAUDE.md / README.md for details).

.PHONY: test native docs-check docs bench dryrun soak

test: native
	python -m pytest tests/ -q

# native threaded WAV decoder -> auditory_tpu/io/libauditory_io.so
native:
	$(MAKE) -C csrc

docs-check:
	python tools/gen_api_docs.py --check

docs:
	python tools/gen_api_docs.py

# ONE JSON line of the headline metric on the default device
bench:
	python bench.py

# 8-virtual-device mesh validation (CPU)
dryrun:
	python -c "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"

# extended randomized parity soak (CPU; N seeds optional: make soak N=200)
N ?= 100
soak:
	python tools/soak.py $(N)
