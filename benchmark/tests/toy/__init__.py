"""A toy model family for the benchmark's CPU tests, laid out as a family
that a new architecture brings: `families/toy.py`, `configs/`, `mixes/`,
`metrics/`, its plain reference (`reference.py`) and, standing in for the
program under test, `program.py`. `manifest.json` is its BENCHMARK.json.
Nothing of the benchmark outside this directory names it."""
