"""``analysis/``: tools that read a finished run (the reference package's
``analysis/``, so far without its linter and project pass).

- :mod:`analysis.run_report`: the metrics JSONL sink, the flight dump and
  the health verdict joined into one report.
"""
