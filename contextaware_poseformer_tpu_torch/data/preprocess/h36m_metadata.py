"""H36M metadata.xml parser (H36M-Toolbox/metadata.py:6-44 equivalent):
maps (subject, action, subaction) to the sequence base filename and lists the
four camera serial ids.

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/h36m_metadata.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

# Public H36M camera serials, in camera-index order.
H36M_CAMERA_IDS = ("54138969", "55011271", "58860488", "60457274")


@dataclass
class H36MMetadata:
    sequence_mappings: dict = field(default_factory=dict)
    action_names: dict = field(default_factory=dict)
    camera_ids: tuple = H36M_CAMERA_IDS

    def get_base_filename(self, subject: str, action: str, subaction: str,
                          camera: str) -> str:
        return f"{self.sequence_mappings[subject][(action, subaction)]}.{camera}"


def load_metadata(path: str = "metadata.xml") -> H36MMetadata:
    md = H36MMetadata()
    tree = ET.parse(path)
    root = tree.getroot()

    for i, tr in enumerate(root.find("mapping").findall("mapping")):
        cells = [td.text for td in tr.findall("cell")]
        if i == 0:
            subjects = cells[2:]
        else:
            action, subaction = cells[:2]
            for subject, base in zip(subjects, cells[2:]):
                md.sequence_mappings.setdefault(subject, {})[
                    (action, subaction)
                ] = base
    for elem in root.find("actionnames").findall("actionname"):
        md.action_names[elem.attrib["act"]] = elem.text
    return md
