"""Images whose logits the client scored in the window, over the window's
host seconds."""


def read(window):
    return window.images / window.seconds
