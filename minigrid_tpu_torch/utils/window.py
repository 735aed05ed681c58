"""Matplotlib display window, for ``render_mode="human"``.

Counterpart of ``minigrid_tpu/utils/window.py`` (the reference's
minigrid/utils/window.py:10-93).  matplotlib is optional: it is imported when
a window opens.
"""

from __future__ import annotations


class Window:
    """Simple imshow window with key-handler registration."""

    def __init__(self, title: str):
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fig, self.ax = plt.subplots()
        self.fig.canvas.manager.set_window_title(title)
        self.imshow_obj = None
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.closed = False

        def close_handler(evt):
            self.closed = True

        self.fig.canvas.mpl_connect("close_event", close_handler)

    def show_img(self, img) -> None:
        if self.imshow_obj is None:
            self.imshow_obj = self.ax.imshow(img, interpolation="bilinear")
        else:
            self.imshow_obj.set_data(img)
        self.fig.canvas.draw_idle()
        self._plt.pause(0.001)

    def set_caption(self, text: str) -> None:
        self.ax.set_xlabel(text)

    def reg_key_handler(self, key_handler) -> None:
        self.fig.canvas.mpl_connect("key_press_event", key_handler)

    def show(self, block: bool = True) -> None:
        self._plt.show(block=block)

    def close(self) -> None:
        self._plt.close(self.fig)
        self.closed = True
