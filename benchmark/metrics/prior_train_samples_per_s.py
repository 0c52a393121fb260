"""prior_train_samples_per_s: two-prior training samples over the window's
whole time (its start to the end of its last step on the device)."""


def read(w):
    return w["rate"]
