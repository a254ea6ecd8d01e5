"""Command-line tools over the port's result documents and runs.

Counterparts of the JAX package's ``tools/`` scripts, each run as
``python -m chainermn_tpu_torch.tools.<name>``:

* :mod:`.ledger` -- ``ingest`` / ``diff`` / ``trend`` over the run ledger;
* :mod:`.obs_report` -- metrics JSONL, flight dumps, lint and protocol
  documents, the ledger and run diffs rendered as tables;
* :mod:`.perf_gate` -- budgets, planner, online-tune, joint, serving, MoE,
  elastic and ledger gates, with the port's own
  :file:`perf_budgets.json`;
* :mod:`.attribution_smoke` -- a two-rank world's flight dumps held to the
  attribution checks;
* :mod:`.elastic_run` / :mod:`.elastic_smoke` -- the supervisor's CLI and
  its chaos and async-checkpoint smoke;
* :mod:`.cmn_lint` -- the static analyzer: entry points run dry, the
  protocol sweep, recorded flight events, committed artifacts;
* :mod:`.check_db_overlap` -- the double-buffered step's two NCCL
  all-reduces and their overlap, from a profile on the cards;
* :mod:`.contention_smoke` -- a two-rank world's contention report held to
  JAX's checks.
"""
