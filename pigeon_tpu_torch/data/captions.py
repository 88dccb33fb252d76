"""Synthetic geo-captions for contrastive CLIP pretraining.

The port's own copy of `pigeon_tpu/data/captions.py`: the reference's
randomised caption templates, Street View ("A Street View photo close to
the town of X in the region of Y in Z." and optional climate, driving
side, compass and month sentences, shuffled) and YFCC ("A photo I took
..."). Randomness flows through an explicit `numpy.random.Generator` with
the JAX package's sequence of calls, so a seeded caption is the same
string in both packages.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np

MONTHS = ("January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December")

#: Countries requiring a "the" article (reference pretrain_dataset.py:36-57).
THE_COUNTRIES = frozenset([
    "Bahamas", "British Virgin Islands", "Cayman Islands", "Cocos Islands",
    "Comoros", "Cook Islands", "Falkland Islands", "Faroe Islands",
    "French Southern Territories", "Maldives", "Marshall Islands",
    "Netherlands", "Northern Mariana Islands", "Paracel Islands",
    "Philippines", "Pitcairn Islands", "Seychelles", "Solomon Islands",
    "Spratly Islands", "Turks and Caicos Islands", "United Arab Emirates",
    "United States",
])

#: Plural-article countries for the YFCC variant
#: (reference pretrain_dataset_yfcc.py:28-56).
PLURAL_COUNTRIES = frozenset([
    "Bahamas", "British Virgin Islands", "Caspian Sea", "Cayman Islands",
    "Central African Republic", "Cocos Islands", "Cook Islands",
    "Democratic Republic of the Congo", "Dominican Republic",
    "Falkland Islands", "Faroe Islands", "Isle of Man", "Maldives",
    "Netherlands", "Northern Mariana Islands", "Philippines",
    "Republic of the Congo", "Seychelles", "Solomon Islands",
    "Turks and Caicos Islands", "United Arab Emirates", "United Kingdom",
    "United States", "United States Minor Outlying Isl", "Vatican City",
    "Virgin Islands, U.S.", "Western Sahara",
])

#: Truncated-name fixes (reference pretrain_dataset_yfcc.py:21-25).
COUNTRY_RENAMES = {
    "South Georgia and the South Sand":
        "South Georgia and the South Sandwich Islands",
    "United States Minor Outlying Isl":
        "United States Minor Outlying Islands",
}


def _valid(value) -> bool:
    """Is a metadata field usable? (str, or non-NaN number)."""
    if value is None:
        return False
    if isinstance(value, str):
        return True
    try:
        return not math.isnan(value)
    except TypeError:
        return True


def compass_direction(heading_deg: float) -> str:
    """Quantize a compass heading to N/E/S/W (reference :221-231)."""
    h = heading_deg % 360
    if h <= 45 or h > 315:
        return "north"
    if h <= 135:
        return "east"
    if h <= 225:
        return "south"
    return "west"


def streetview_caption(meta: Mapping, heading_offset: float = 0.0,
                       rng: Optional[np.random.Generator] = None,
                       auxiliary: bool = True) -> str:
    """Randomized Street View caption from geo metadata.

    Args:
        meta: mapping with keys ``country_name`` (required) and optionally
            ``geo_area``, ``town``, ``climate_zone``, ``driving_right``,
            ``heading``, ``month``.
        heading_offset: degrees added to the stored heading (which of the
            4 panorama views this caption describes).
        rng: numpy Generator (default: fresh nondeterministic).
        auxiliary: include auxiliary sentences; if False, returns only the
            location sentence.
    """
    rng = rng or np.random.default_rng()
    country = str(meta["country_name"])
    if country == "United States Of America":
        country = "United States"
    if country in THE_COUNTRIES:
        country = f"the {country}"

    region = (f"in the region of {meta['geo_area']} "
              if _valid(meta.get("geo_area")) and rng.random() > 0.4 else "")
    town = (f"close to the town of {meta['town']} "
            if _valid(meta.get("town")) and rng.random() > 0.6 else "")

    climate = ""
    if _valid(meta.get("climate_zone")) and rng.random() > 0.6:
        climate = f" This location has {str(meta['climate_zone']).lower()}."

    location = ""
    if rng.random() > 0.3 or climate == "" or not auxiliary:
        location = f"A Street View photo {town}{region}in {country}."
        if not auxiliary:
            return location

    driving = ""
    if _valid(meta.get("driving_right")) and climate == "" \
            and rng.random() > 0.7:
        side = "right" if meta["driving_right"] else "left"
        driving = (" In this location, people drive on the "
                   f"{side} side of the road.")

    compass = ""
    if _valid(meta.get("heading")) and rng.random() > 0.7:
        d = compass_direction(float(meta["heading"]) + heading_offset)
        compass = f" This photo is facing {d}."

    month = ""
    if _valid(meta.get("month")) and rng.random() > 0.7:
        month = f" The photo was taken in {MONTHS[int(meta['month'])]}."

    others = [climate, driving, compass, month]
    rng.shuffle(others)
    return "".join([location] + others).strip()


def yfcc_caption(meta: Mapping,
                 rng: Optional[np.random.Generator] = None,
                 auxiliary: bool = True,
                 driving_side: Optional[Mapping[str, str]] = None) -> str:
    """Randomized YFCC caption ("A photo I took ...") from geo metadata.

    Region and town are always included when available (reference
    pretrain_dataset_yfcc.py:118-127 uses probability > 0.0).
    """
    rng = rng or np.random.default_rng()
    country = str(meta["country_name"])
    if country == "United States Of America":
        country = "United States"

    display = COUNTRY_RENAMES.get(country, country)
    if country in PLURAL_COUNTRIES:
        display = f"the {display}"

    region = (f"in the region of {meta['geo_area']} "
              if _valid(meta.get("geo_area")) else "")
    town = (f"close to the town of {meta['town']} "
            if _valid(meta.get("town")) else "")

    climate = ""
    if _valid(meta.get("climate_zone")) and rng.random() > 0.55:
        climate = (f" This location has a {str(meta['climate_zone']).lower()}"
                   " climate.")

    location = ""
    if rng.random() > 0.2 or climate == "" or not auxiliary:
        location = f"A photo I took {town}{region}in {display}."
        if not auxiliary:
            return location

    driving = ""
    if driving_side and country in driving_side and climate == "" \
            and rng.random() > 0.8:
        driving = (" In this location, people drive on the "
                   f"{driving_side[country]} side of the road.")

    others = [climate, driving]
    rng.shuffle(others)
    return "".join([location] + others).strip()
