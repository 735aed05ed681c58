"""One module per configuration's task: how its levels are made or checked,
and what the task adds to the MiniGrid step.  The harness finds a
configuration's module by the ``task`` key of its file."""
