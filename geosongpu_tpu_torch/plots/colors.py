"""Palettes (the port's copy of geosongpu_tpu/plots/colors.py, the
reference's tcn/plots/colors.py:1-22): a NASA-blue retro palette and a
colorblind-inclusive palette."""

NASA_RETRO = [
    "#105bd8",  # NASA blue
    "#0b3d91",
    "#fc3d21",  # NASA red
    "#ffffff",
    "#aeb0b5",
]

COLORBLIND_INCLUSIVE = [
    "#0072b2",  # blue
    "#e69f00",  # orange
    "#009e73",  # green
    "#cc79a7",  # pink
    "#56b4e9",  # sky
    "#d55e00",  # vermillion
    "#f0e442",  # yellow
    "#000000",  # black
]
