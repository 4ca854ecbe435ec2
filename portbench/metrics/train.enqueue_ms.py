"""Host time from the trainer's on_train_batch_start to its
on_train_batch_end, with no synchronise: the step's enqueue, mean over the
window's steps."""


def read(run):
    return run.spans.mean_ms("pb.step")
