"""Host milliseconds of one tokenization call of a chunk
(``StudentModel.tokenize_batch`` or ``TeacherModel.tokenize_pairs``), the
mean over the window."""

from benchmark.harness.readers import mean_ms


def read(run, entry, trace):
    return mean_ms(run, "tokenize")
