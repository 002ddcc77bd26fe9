"""train_images_per_s: training images completed in the window (steps
times the batch) over the window's seconds."""


def read(r):
    return r["images"] / r["window_s"]
