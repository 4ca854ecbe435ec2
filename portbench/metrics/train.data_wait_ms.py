"""Host time from the trainer's on_train_batch_end to the next
on_train_batch_start: the wait for the loader's next batch and the loop's
bookkeeping, mean over the window's steps."""


def read(run):
    return run.spans.mean_ms("pb.data")
