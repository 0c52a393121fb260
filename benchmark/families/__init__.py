"""Model families of the benchmark: one file `families/<family>.py` each,
which the harness loads by path (`harness.load_family`), as it loads a
metric's reader. A configuration file (`configs/<name>.json`) names its
family in a top-level "family" key beside "cfg"; without the key the
family is `lion`. A new architecture's cell is new files only: its
configuration, its mixes, its family file with its plain reference, and
the readers of its own metrics.

A family module gives:

  port_config(cfg)        the program's configuration made from the file's
                          "cfg" tree
  make_weights(cfg, seed, device)
                          the state dict of the whole model, drawn from the
                          seed on the device, in the type it is served in
  KINDS                   mix kind -> its `benchmark.traffic.Traffic` class
  check(cfg, mix, state, kept, device)
                          the numbers the mix's `limits` name (and any
                          others it reads), the plain reference in full
                          float32 on the benchmark's own weights and inputs
  work_of(cfg, mix, device)
                          a function that runs one unit of the mix (a
                          request, or a training step's forward and
                          backward) on the reference built on `device`;
                          `benchmark.work` counts it on the meta device
  REFERENCE               the path of its plain reference (a module or a
                          package), relative to the directory that holds
                          `families/`; it imports nothing of the program

what the benchmark's own tests and `calibrate.py` read of every cell:

  CONTROL                 dotted configuration keys that switch on the
                          program's path in the nearest precision below
                          the configuration's (the check's control)
  FAULTS, OF_KIND         fault name -> function(kind) giving a context
                          manager that breaks the timed path; mix kind ->
                          the faults a cell of that kind can have
  TINY                    dotted configuration keys of small sizes for the
                          CPU tests

and may give:

  COUNTERS                `TorchDispatchMode` classes with a `numbers()`
                          method; `work.unit_work` runs each beside the
                          model FLOPs and the convolutions' counter and
                          merges its numbers (a `<name>_least_s` is what
                          `readers.roofline` reads)
  GROUPS                  kernel-name substring -> group label, tried after
                          the port's own kernel names and before
                          `trace.group`'s generic fallbacks
"""
