"""Command-line tools over the port's artifacts; the counterparts of the
reference repo's ``tools/`` scripts, run as ``python -m
k8s_spark_scheduler_tpu_torch.tools.<name>``.

- :mod:`.policy_regression` — the policy-regression gate over a
  simulator scorecard or a lab matrix document.
"""
