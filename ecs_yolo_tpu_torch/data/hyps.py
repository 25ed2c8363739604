"""Hyper-parameter presets (reference data/hyps/hyp.scratch.yaml and
hyp.scratch-high.yaml; the values of ``ecs_yolo_tpu/data/hyps.py``)."""

HYP_SCRATCH = dict(
    lr0=0.01, lrf=0.1, momentum=0.937, weight_decay=0.0005,
    warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
    box=0.05, cls=0.5, cls_pw=1.0, obj=1.0, obj_pw=1.0,
    iou_t=0.20, anchor_t=4.0, fl_gamma=0.0, slide_ratio=0.0,
    label_smoothing=0.0,
    hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
    degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
    flipud=0.0, fliplr=0.5, mosaic=1.0, mixup=0.0, copy_paste=0.0,
)

HYP_SCRATCH_HIGH = dict(
    HYP_SCRATCH,
    lr0=0.01, lrf=0.01,
    box=7.5, cls=0.5, dfl=1.5,
    mixup=0.15, copy_paste=0.3, scale=0.9, close_mosaic=15,
)
