"""model_rel_err: ||Y_c - Y_o||^2 / ||Y_o||^2 of the classifier head's input
on the held-out batch, the window's last compressed model (Y_c) against the
original (Y_o), both by the plain reference in f32 with TF32 off."""


def read(ctx):
    return ctx.check["detail"]["model_rel_err"]
