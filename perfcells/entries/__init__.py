"""How each entry point of the program is driven, one file per entry kind,
named by a configuration's `entry`. Each defines `Entry(run)` with:

* `rays_per_call` (source rays a call traces), `source_rays` (the source
  rays this rank's first launch of a call holds, in its first slots) and
  `capacity` (ray slots a bounce: a call's bounces are its
  `rays_traced / capacity`);
* `warm()`: one call of the window's shapes, during set-up;
* `call(i)`: the window's call i, seeded `seed + i`, returning the
  program's TraceResult;
* `program_outcome(result)` and `reference_outcome(i, dtype)`: what the
  check compares, as shares of the power emitted (`verdict.gaps`);
* `opts`: the trace semantics the reference follows.
"""
