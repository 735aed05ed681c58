"""The program's span ``babyai.clauses`` (the composite verifier's clause
evaluation, ``verifier._eval_clauses``) in host ms a traced step,
inclusive, under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "babyai.clauses")
