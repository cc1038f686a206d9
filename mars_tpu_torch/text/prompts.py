"""Prompt-template data for the text path (the port's own copy of
``mars_tpu/text/prompts.py``).

These strings are behavioral data the pipeline's accuracy depends on —
reproduced from the reference (mars/components/helpers/prompts.py:1-53,
mars/utils/coco_prompts.py) so that VLM queries and CLIP text prompts elicit
the same responses/embeddings; the surrounding code is original.
"""

# VLM chat template (reference helpers/prompts.py:29)
VLM_SYSTEM_TEMPLATE = "Human: <image>\n{}\nAssistant:"

# reference helpers/prompts.py:31-35
COLORS = {
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "blue": (0, 0, 255),
}

# class-name question per visual-prompt type (reference :37-42; the "ny"
# typo is preserved deliberately — it is part of the prompt the VLM sees)
VISUAL_PROMPTS = {
    "mask": "What is the name of the object highlighted with a {} mask in the image? Your output must be only the class name of the object. Do not add ny additional text.",
    "bb": "What is the name of the object inside the {} rectangle in the image? Your output must be only the class name of the object. Do not add ny additional text.",
    "contour": "What is the name of the object inside the {} mask contour? Your output must be only the class name of the object. Do not add ny additional text.",
    "ellipse": "What is the name of the object inside the {} ellipses? Your output must be only the class name of the object. Do not add ny additional text.",
}

# definition question per visual-prompt type (reference :44-49)
VISUAL_PROMPTS_DESCRIPTIONS = {
    "mask": "Given the image provided, identify and provide the definition of the {} highlighted by the {} mask.",
    "bb": "Given the image provided, identify and provide the definition of the {} inside the {} rectangle.",
    "contour": "Given the image provided, identify and provide the definition of the {} inside the {} mask contour.",
    "ellipse": "Given the image provided, identify and provide the definition of the {} inside the {} ellipses. ",
}

# CLIP-ES style ensemble templates (reference mars/utils/coco_prompts.py:86-102)
COCO_TEMPLATES = [
    "a {}.",
    "a bad {}.",
    "a good {}.",
    "a small {}.",
    "a tiny {}.",
    "a big {}.",
    "a low contrast {}.",
    "a high contrast {}.",
    "a blurry {}.",
    'a zoomed in {}".',
    'a close up of a {}".',
    "an occluded {}.",
    "a partially visible {}.",
    "a partially hidden {}.",
    "a {} behind another object.",
]

COCO_TEMPLATES_WITH_DESCRIPTIONS = [
    "a {}, {}.",
    "a bad {}, {}.",
    "a good {}, {}.",
    "a small {}, {}.",
    "a tiny {}, {}.",
    "a big {}, {}.",
    "a low contrast {}, {}.",
    "a high contrast {}, {}.",
    "a blurry {}, {}.",
    "a zoomed in {}, {}.",
    "a close up of a {}, {}.",
    "an occluded {}, {}.",
    "a partially visible {}, {}.",
    "a partially hidden {}, {}.",
    "a {}, {}, behind another object.",
]


def vta_text_pair(label: str, use_multiple_prompts: bool = False):
    """Foreground/background prompt strings for the Grad-CAM text features
    (reference SoftmaxGradCAM.compute_text_feats:85-92)."""
    if use_multiple_prompts:
        fg = [t.format(label) for t in COCO_TEMPLATES]
    else:
        fg = [f"a photo of {label}."]
    bg = [f"a photo without {label}."]
    return fg, bg


def alpha_clip_text(name: str, description: str) -> str:
    """AlphaCLIP ranking text (reference mars/MARS.py:84-89)."""
    if description:
        return f"a {name}, {description}."
    return f"a {name}."
