"""serve_images_per_s: images completed in the window over the window's
seconds (first request's start to last output on the host)."""


def read(r):
    return r["images"] / r["window_s"]
