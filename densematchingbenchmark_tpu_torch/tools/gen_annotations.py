"""Generate reference-format JSON annotation files for stereo datasets.

    python -m densematchingbenchmark_tpu_torch.tools.gen_annotations \\
        --dataset SceneFlow --data-root /data/SceneFlow --out-dir anns \\
        [--data-type final]

The port's own copy of the repository's tools/gen_annotations.py:25-122
(the reference's tools/datasets/gen_sceneflow_anns.py and
gen_kitti2015_anns.py): walk the dataset's directory tree and write JSON
lists of {left_image_path, right_image_path, left_disp_map_path,
right_disp_map_path} relative to the data root, the schema the port's
file datasets read. It walks files and touches no device, so it takes no
--cpu.

Layouts:
  SceneFlow: frames_cleanpass/finalpass + disparity trees for
    flyingthings3d (TRAIN/TEST x A/B/C), Monkaa (scenes), Driving
    (focal/direction/speed); <clean|final>pass_{train,test}.json.
  KITTI-2015/2012: training/image_2 + image_3 + disp_occ_0 (2015) or
    colored_0/colored_1/disp_occ (2012); testing/ without GT;
    full_{train,test}.json.
"""

import argparse
import json
import os
import os.path as osp


def _rel_pair(img_dir, disp_dir, stem, img_ext=".png", disp_ext=".pfm"):
    return dict(
        left_image_path=osp.join(img_dir, "left", stem + img_ext),
        right_image_path=osp.join(img_dir, "right", stem + img_ext),
        left_disp_map_path=osp.join(disp_dir, "left", stem + disp_ext),
        right_disp_map_path=osp.join(disp_dir, "right", stem + disp_ext))


def scene_flow_metas(root, split, data_type="clean"):
    metas = []
    pass_dir = f"frames_{data_type}pass"

    # flyingthings3d: <dataset>/<pass|disparity>/<TRAIN|TEST>/<A|B|C>/<idx>/
    ft_disp = osp.join("flyingthings3d", "disparity", split)
    if osp.isdir(osp.join(root, ft_disp)):
        for part in sorted(os.listdir(osp.join(root, ft_disp))):
            part_dir = osp.join(ft_disp, part)
            for idx in sorted(os.listdir(osp.join(root, part_dir))):
                left_dir = osp.join(root, part_dir, idx, "left")
                for name in sorted(os.listdir(left_dir)):
                    stem = name.split(".")[0]
                    metas.append(_rel_pair(
                        osp.join("flyingthings3d", pass_dir, split, part,
                                 idx),
                        osp.join(part_dir, idx), stem))

    # Monkaa / Driving (no TRAIN/TEST split; scene subtrees), train only
    if split == "TRAIN":
        for ds in ("Monkaa", "Driving"):
            disp_root = osp.join(ds, "disparity")
            if not osp.isdir(osp.join(root, disp_root)):
                continue
            for cur, dirs, _ in os.walk(osp.join(root, disp_root)):
                if osp.basename(cur) != "left":
                    continue
                scene_rel = osp.relpath(osp.dirname(cur),
                                        osp.join(root, disp_root))
                for name in sorted(os.listdir(cur)):
                    stem = name.split(".")[0]
                    metas.append(_rel_pair(
                        osp.join(ds, pass_dir, scene_rel),
                        osp.join(disp_root, scene_rel), stem))
    return metas


def kitti_metas(root, split, year=2015):
    metas = []
    if year == 2015:
        left_dir, right_dir, disp_dir = "image_2", "image_3", "disp_occ_0"
    else:
        left_dir, right_dir, disp_dir = "colored_0", "colored_1", "disp_occ"
    base = osp.join(split, left_dir)
    for name in sorted(os.listdir(osp.join(root, base))):
        if not name.endswith("_10.png"):
            continue
        meta = dict(
            left_image_path=osp.join(split, left_dir, name),
            right_image_path=osp.join(split, right_dir, name))
        disp_path = osp.join(split, disp_dir, name)
        if osp.exists(osp.join(root, disp_path)):
            meta["left_disp_map_path"] = disp_path
        metas.append(meta)
    return metas


def main(argv=None):
    """Returns {output path: number of samples}."""
    p = argparse.ArgumentParser(description="Generate annotation JSONs")
    p.add_argument("--dataset", required=True,
                   choices=["SceneFlow", "KITTI-2015", "KITTI-2012"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--data-type", default="clean",
                   choices=["clean", "final"], help="SceneFlow pass")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.dataset == "SceneFlow":
        outputs = {
            f"{args.data_type}pass_train.json":
                scene_flow_metas(args.data_root, "TRAIN", args.data_type),
            f"{args.data_type}pass_test.json":
                scene_flow_metas(args.data_root, "TEST", args.data_type),
        }
    else:
        year = 2015 if args.dataset == "KITTI-2015" else 2012
        outputs = {
            "full_train.json": kitti_metas(args.data_root, "training", year),
            "full_test.json": kitti_metas(args.data_root, "testing", year),
        }
    written = {}
    for name, metas in outputs.items():
        path = osp.join(args.out_dir, name)
        with open(path, "w") as fp:
            json.dump(metas, fp)
        print(f"{path}: {len(metas)} samples")
        written[path] = len(metas)
    return written


if __name__ == "__main__":
    main()
