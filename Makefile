PY ?= python

.PHONY: all native test test-fast bench smoke demo clean

all: native

native: native/libsolid_runtime.so

# portable baseline (x86-64-v2 on x86 only): release artifacts must not
# SIGILL on CPUs older than the build machine, and non-x86 hosts get no
# arch flag; local builds can override CXXFLAGS_ARCH.
UNAME_M := $(shell uname -m)
ifeq ($(UNAME_M),x86_64)
CXXFLAGS_ARCH ?= -march=x86-64-v2
else
CXXFLAGS_ARCH ?=
endif

native/libsolid_runtime.so: native/solid_runtime.cc
	g++ -O3 $(CXXFLAGS_ARCH) -std=c++17 -shared -fPIC -pthread $< -o $@

test: native
	$(PY) -m pytest tests/ -q

test-fast: native
	$(PY) -m pytest tests/ -q -x -m "not slow"

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

demo:
	$(PY) -m solid_dsp_tpu demo

clean:
	rm -f native/libsolid_runtime.so
	find . -name __pycache__ -type d | xargs rm -rf
