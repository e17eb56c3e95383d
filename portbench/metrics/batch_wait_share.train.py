"""The loop's wait for its next batch plus the batch's copy to the card
(CUDA events around the copy), over the sum of the step times, in percent:
``apps/train_diffusion.py:train``'s arithmetic over the window's steps."""


def read(run):
    if not run.work.get("step_s"):
        return None
    return 100.0 * run.work["batch_wait_s"] / run.work["step_s"]
